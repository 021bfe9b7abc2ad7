"""The command line's -tune and -tdauto against lzma_tpu's, on the CPU.

The files of ``python -m lzma_tpu_torch e -tune ...`` (lc/lp/pb chosen by
utils.autotune.select_params on the input's first bytes) and of
``e -tune -tdauto -bs{N}`` (and a dictionary sized by
utils.dicttrain.select_dictionary) must equal lzma_tpu.cli.main's on its
-backendtpu route, byte for byte, and print the same "tuned:" line.
Tests that need g++ skip without it.
"""

import lzma

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import lzma_tpu  # noqa: E402
from lzma_tpu import cli as jcli  # noqa: E402
from lzma_tpu.runtime import native as jnative  # noqa: E402
from lzma_tpu_torch import cli as tcli  # noqa: E402
from lzma_tpu_torch.runtime import native  # noqa: E402


@pytest.fixture(scope="module")
def host():
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain")


def _input():
    """Word-aligned binary (uint32 counters, where -tune moves off lc3 lp0
    pb2) and records drawn from one vocabulary (which a dictionary
    captures), ~3 KiB."""
    rng = np.random.default_rng(11)
    words = (np.arange(400, dtype=np.uint32) * 5
             + rng.integers(0, 3, 400, dtype=np.uint32)).tobytes()
    vocab = [rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
             for _ in range(10)]
    recs = b"".join(vocab[i] + bytes(rng.integers(97, 123, 4, dtype=np.uint8))
                    for i in rng.integers(0, len(vocab), 30))
    return words + recs


CASES = {
    "tune": ["e", "-tune", "-d16"],
    "tune-tdauto-bs": ["e", "-tune", "-tdauto", "-bs1024", "-d12"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_auto_files_match_jax(host, name, tmp_path, capsys):
    data = _input()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    args = CASES[name]
    j_out, t_out = tmp_path / "j.out", tmp_path / "t.out"
    assert jcli.main([*args, "-backendtpu", str(src), str(j_out)]) == 0
    j_tuned = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("tuned:")]
    assert tcli.main([*args, "-backendtpu", str(src), str(t_out)],
                     device="cpu") == 0
    t_tuned = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("tuned:")]
    assert t_tuned == j_tuned and len(t_tuned) == 1
    assert t_tuned != ["tuned: -lc3 -lp0 -pb2"]
    blob = t_out.read_bytes()
    assert blob == j_out.read_bytes()
    assert lzma_tpu.decompress(blob) == data
    if name == "tune":
        assert lzma.decompress(blob, format=lzma.FORMAT_ALONE) == data
    else:
        assert blob[4] == 3   # LZTB v3: -tdauto stored a dictionary
