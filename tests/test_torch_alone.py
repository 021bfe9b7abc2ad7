"""The port's `.lzma` single-stream path against lzma_tpu's, on the CPU.

The EOS marker (encode_batch(write_eos=True), both parses), the classify
scan split into its carry and its finish, encode_lanes,
encode/decode_stream and encode/decode_alone (JAX's and the stdlib's EOS
streams, a forged size field, the EOS cap's growth and ceiling), each
held byte for byte to lzma_tpu (tolerance zero: the codec is
integer-only).  Sizes stay small: the plain decoder and range coder take
a step a bit.  (The front door and the command line: test_torch_cli.py.)
"""

import lzma

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.bench.corpus import text_part  # noqa: E402
from lzma_tpu.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu.core.rangecoder import CorruptStreamError as JCorrupt  # noqa: E402
from lzma_tpu.format.properties import LzmaParams  # noqa: E402
from lzma_tpu.ops import api as japi  # noqa: E402
from lzma_tpu.ops import device_encoder as jde  # noqa: E402
from lzma_tpu.ops.device_matcher import tokenize as jax_tokenize  # noqa: E402
from lzma_tpu_torch.core.rangecoder import CorruptStreamError  # noqa: E402
from lzma_tpu_torch.ops import api as tapi  # noqa: E402
from lzma_tpu_torch.ops import device_encoder as tde  # noqa: E402
from lzma_tpu_torch.ops.api import from_numpy  # noqa: E402
from lzma_tpu_torch.ops.device_decoder import CapExceededError  # noqa: E402

TEXT = text_part()[:600]
BLOCKS = [generate_bench_data(700), b"abcabcabd" * 20, b"", b"x"]


def _stdlib(blob):
    return lzma.decompress(blob, format=lzma.FORMAT_ALONE)


# ------------------------------------------------------------ EOS marker
@pytest.mark.parametrize("parse", ["lazy", "optimal"])
def test_eos_encode_batch_matches_jax(parse):
    params = LzmaParams(write_eos=True)
    got = tde.encode_batch(BLOCKS, params, write_eos=True, parse=parse,
                           device="cpu")
    assert got == jde.encode_batch(BLOCKS, params, write_eos=True, parse=parse)
    head = params.encode_props() + (2**64 - 1).to_bytes(8, "little")
    for stream, block in zip(got, BLOCKS):
        assert _stdlib(head + stream) == block


def _eos_tokens(n_lanes=3, max_n=512):
    data = np.frombuffer(generate_bench_data(n_lanes * max_n),
                         np.uint8).reshape(n_lanes, max_n).copy()
    lens = np.asarray([max_n, max_n - 100, 7], np.int32)
    tok = jax.vmap(lambda d, n: jax_tokenize(d, n, max_n, 32, 4))(
        jnp.asarray(data), jnp.asarray(lens))
    return data, lens, tok


def test_eos_tokens_and_classify_split_match_jax():
    data, lens, tok = _eos_tokens()
    j_eos = jde._append_eos_tokens(*tok[:4], tok[4], jnp.asarray(lens))
    meta = jde.classify_tokens(jnp.asarray(data), *j_eos)
    t_data, t_lens, *t_tok = from_numpy(data, lens, *map(np.asarray, tok),
                                        device="cpu")
    t_eos = tde._append_eos_tokens(*t_tok[:4], t_tok[4], t_lens)
    for name, r, g in zip(("t_pos", "t_len", "t_dist", "t_valid"), j_eos, t_eos):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert t_eos[0].shape[1] == data.shape[1] + 1
    t_meta = tde.classify_tokens(t_data, *t_eos)
    for r, g in zip(meta, t_meta):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # the carry and the finish make classify_tokens, also with invalid
    # tokens inside a lane (they hold the carry)
    t_pos, t_len, t_dist, t_valid = t_eos
    holes = t_valid.clone()
    holes[:, 3::5] = False
    for valid in (t_valid, holes):
        rows = tde._classify_rows(t_len, t_dist, valid)
        carry = tde._classify_carry(*rows)
        assert all(c.dtype == torch.int32 and c.shape == rows[0].shape
                   for c in carry)
        split = tde._classify_finish(t_data, t_pos, t_dist, carry)
        whole = tde.classify_tokens(t_data, t_pos, t_len, t_dist, valid)
        assert all(torch.equal(a, b) for a, b in zip(split, whole))
    j_meta = jde.classify_tokens(jnp.asarray(data), *j_eos[:3],
                                 jnp.asarray(holes.numpy()))
    for r, g in zip(j_meta, tde.classify_tokens(t_data, t_pos, t_len, t_dist,
                                                holes)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_encode_lanes_matches_jax_with_eos_and_preset():
    data = np.frombuffer(generate_bench_data(2 * 512), np.uint8).reshape(2, 512)
    lens = np.asarray([512, 300], np.int32)
    preset = np.frombuffer(b"abcab" * 40, np.uint8)
    kw = dict(lc=1, lp=1, pb=1, fb=16, num_candidates=4)
    j_out, j_lens = jde.encode_lanes(jnp.asarray(data), jnp.asarray(lens), 1024,
                                     preset=jnp.asarray(preset),
                                     write_eos=True, **kw)
    t_data, t_lens, t_pre = from_numpy(data, lens, preset, device="cpu")
    out, out_lens = tde.encode_lanes(t_data, t_lens, 1024, preset=t_pre,
                                     write_eos=True, **kw)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out)[:, :out.shape[1]])


# -------------------------------------------------- streams and .lzma files
@pytest.mark.parametrize("kw", [dict(), dict(write_eos=True),
                                dict(lc=0, lp=2, pb=1, dict_size=1 << 12,
                                     fast_bytes=16, write_eos=True)],
                         ids=["known-size", "eos", "lc0lp2pb1-eos"])
def test_encode_alone_matches_jax_and_round_trips(kw):
    params = LzmaParams(**kw)
    blob = tapi.encode_alone(TEXT, params, device="cpu")
    assert blob == japi.encode_alone(TEXT, params)
    assert tapi.decode_alone(blob, device="cpu") == TEXT
    assert _stdlib(blob) == TEXT
    if params.lc == 0:
        assert tapi.encode_stream(TEXT[:200], params, device="cpu") == \
            japi.encode_stream(TEXT[:200], params)


def test_decode_alone_and_stream_read_stdlib_eos_streams():
    data = generate_bench_data(900)
    filt = [{"id": lzma.FILTER_LZMA1, "preset": 6, "dict_size": 1 << 16}]
    blob = lzma.compress(data, format=lzma.FORMAT_ALONE, filters=filt)
    assert blob[5:13] == b"\xff" * 8
    assert tapi.decode_alone(blob, device="cpu") == data
    from lzma_tpu_torch.format.properties import decode_props

    params = decode_props(blob[:5])
    assert tapi.decode_stream(blob[13:], params, -4096, device="cpu") == data
    known = lzma.compress(data, format=lzma.FORMAT_ALONE,
                          filters=[{"id": lzma.FILTER_LZMA1, "preset": 6}])
    sized = known[:5] + len(data).to_bytes(8, "little") + known[13:]
    assert tapi.decode_alone(sized, device="cpu") == data


def test_decode_alone_refuses_forged_and_short_inputs():
    blob = japi.encode_alone(TEXT[:300], LzmaParams())
    forged = blob[:5] + (1 << 40).to_bytes(8, "little") + blob[13:]
    with pytest.raises(JCorrupt):
        japi.decode_alone(forged)
    with pytest.raises(CorruptStreamError, match="impossible"):
        tapi.decode_alone(forged, device="cpu")
    with pytest.raises(CorruptStreamError):
        tapi.decode_alone(blob[:12], device="cpu")
    with pytest.raises(ValueError):
        tapi.decode_alone(b"\xff" + blob[1:], device="cpu")
    # a size field past the device's int32 range, inside the expansion
    # bound, is refused before any buffer is sized
    big = bytes(blob[:5]) + (1 << 31).to_bytes(8, "little") + b"\0" * (1 << 18)
    with pytest.raises(CorruptStreamError):
        tapi.decode_alone(big, device="cpu")


def test_eos_cap_grows_by_four_up_to_the_ceiling(monkeypatch):
    """The cap of an EOS stream: 16 bytes a coded byte but at least 64 KiB,
    then x4 a retry, up to min(273 bytes a coded byte + 512, the
    ceiling); past the ceiling the lane's CapExceededError stands."""
    caps = []

    def decode(streams, params, sizes, device="cuda"):
        caps.append(-sizes[0])
        if -sizes[0] < need:
            raise CapExceededError("cap")
        return [b"ok"]

    monkeypatch.setattr(tapi, "decode_batch_cuda", decode)
    comp_len = 10_000
    blob = LzmaParams(write_eos=True).encode_props() + b"\xff" * 8 \
        + bytes(comp_len)
    need = 1 << 20
    assert tapi.decode_alone(blob, device="cpu") == b"ok"
    assert caps == [160_000, 640_000, 2_560_000]
    caps.clear()
    need = 1 << 40
    with pytest.raises(CapExceededError, match="ceiling"):
        tapi.decode_alone(blob, device="cpu")
    assert caps == [160_000, 640_000, 2_560_000, 2_730_512]
    caps.clear()
    monkeypatch.setenv("LZMA_TPU_DEVICE_EOS_CEILING", "100000")
    with pytest.raises(CapExceededError):
        tapi.decode_alone(blob, device="cpu")
    assert caps == [100_000]
    caps.clear()
    small = blob[:13] + bytes(100)
    monkeypatch.delenv("LZMA_TPU_DEVICE_EOS_CEILING")
    with pytest.raises(CapExceededError):
        tapi.decode_alone(small, device="cpu")
    assert caps == [27_812]


def test_eos_ceiling_raises_on_a_real_stream(monkeypatch):
    blob = japi.encode_alone(TEXT[:500], LzmaParams(write_eos=True))
    monkeypatch.setenv("LZMA_TPU_DEVICE_EOS_CEILING", "400")
    with pytest.raises(CapExceededError, match="400-byte ceiling"):
        tapi.decode_alone(blob, device="cpu")
    monkeypatch.setenv("LZMA_TPU_DEVICE_EOS_CEILING", "800")
    assert tapi.decode_alone(blob, device="cpu") == TEXT[:500]
