"""The port's front door and command line against lzma_tpu's, on the CPU.

lzma_tpu_torch.compress/decompress against lzma_tpu.compress(container=
"lztb", backend="device") (LZTB v1 and a trained dictionary's v3) and the files of ``python -m lzma_tpu_torch e|d`` against
lzma_tpu.cli.main(..., "-backendtpu"), byte for byte; what the device
codec lacks (the host codecs' backends, the hybrid's switches) ends in
"error: ..." and exit 1.  Sizes stay small: the plain decoder
takes a step a bit.
"""

import os
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

import lzma_tpu  # noqa: E402
import lzma_tpu_torch  # noqa: E402
from lzma_tpu import cli as jcli  # noqa: E402
from lzma_tpu.bench.corpus import text_part  # noqa: E402
from lzma_tpu.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu.format.properties import LzmaParams  # noqa: E402
from lzma_tpu.ops import api as japi  # noqa: E402
from lzma_tpu_torch import cli as tcli  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = text_part()[:600]


# ------------------------------------------------------------ front door
@pytest.mark.parametrize("kw,version", [(dict(), 1), (dict(train_dict=200), 3)],
                         ids=["v1", "v3-trained"])
def test_compress_matches_jax_device_backend(kw, version):
    data = generate_bench_data(1200)
    params = LzmaParams(dict_size=1 << 12)
    ref = lzma_tpu.compress(data, params, container="lztb", backend="device",
                            block_size=512, **kw)
    got = lzma_tpu_torch.compress(data, params, block_size=512, device="cpu",
                                  **kw)
    assert got == ref
    assert got[4] == version
    assert lzma_tpu_torch.decompress(got, device="cpu") == data


def test_decompress_reads_alone_files_and_compress_refuses():
    blob = japi.encode_alone(TEXT[:400], LzmaParams(write_eos=True))
    assert lzma_tpu_torch.decompress(blob, device="cpu") == TEXT[:400]
    for kw, err in ((dict(container="alone"), ValueError),
                    (dict(container="zip"), ValueError),
                    (dict(backend="native"), ValueError),
                    (dict(train_dict=64, dictionary=b"xyz"), ValueError)):
        with pytest.raises(err):
            lzma_tpu_torch.compress(TEXT, device="cpu", **kw)


# ------------------------------------------------------------ command line
CLI_CASES = {
    "e": ["e", "-d16", "-fb64"],
    "e-eos": ["e", "-eos", "-lc1", "-lp1", "-pb0"],
    "e-bs-td": ["e", "-bs400", "-td200", "-d12"],
}


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_cli_files_match_jax(name, tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(TEXT)
    args = CLI_CASES[name]
    j_out, t_out = tmp_path / "j.out", tmp_path / "t.out"
    assert jcli.main([*args, "-backendtpu", str(src), str(j_out)]) == 0
    assert tcli.main([*args, "-backendtpu", "-q", str(src), str(t_out)],
                     device="cpu") == 0
    assert t_out.read_bytes() == j_out.read_bytes()
    back = tmp_path / "back.bin"
    assert tcli.main(["d", "-q", str(t_out), str(back)], device="cpu") == 0
    assert back.read_bytes() == TEXT


@pytest.mark.parametrize("args", [
    ["e", "-mfbt2"], ["e", "-a1"],
    ["e", "-backendnative"], ["e", "-t4"], ["e", "-td50"],
    ["e", "-eos", "-bs400"], ["d"]], ids=lambda a: " ".join(a))
def test_cli_refuses_what_the_device_codec_lacks(args, tmp_path, capsys):
    src = tmp_path / "in.bin"
    src.write_bytes(TEXT[:100])
    if args == ["d"]:
        args = ["d", str(src), str(tmp_path / "out")]   # not an LZMA file
    else:
        args = [*args, str(src), str(tmp_path / "out")]
    assert tcli.main(args, device="cpu") == 1
    assert "error:" in capsys.readouterr().out
    assert tcli.main(["x"], device="cpu") == 1
    assert tcli.main(["e", "-zz", "a", "b"], device="cpu") == 1


def test_python_m_prints_usage_and_refuses_the_benchmark():
    run = [sys.executable, "-m", "lzma_tpu_torch"]
    done = subprocess.run(run, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0 and "Usage:" in done.stdout
    done = subprocess.run([*run, "b", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 1 and "Incorrect command" in done.stdout
