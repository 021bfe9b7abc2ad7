"""lzma_tpu_torch's plain decoder FSM against lzma_tpu's, on the CPU.

The port's ``_decode_fsm`` (the plain version of both CUDA decoders) is
held to the JAX ring kernel in interpret mode and to the JAX FSM on the
same numpy inputs, and ``decode_batch_resident`` (K5's entry point) to
the JAX ``decode_batch_pallas`` with ``fallback=False``.  The codec is integer-only: out, ok and the final
output position must be exactly equal, on valid and on corrupt streams.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu.codec.encoder import encode_stream  # noqa: E402
from lzma_tpu.format.properties import LzmaParams  # noqa: E402
from lzma_tpu.ops import device_decoder as jdd  # noqa: E402
from lzma_tpu.ops.pallas_decoder import decode_batch_pallas  # noqa: E402
from lzma_tpu.ops.pallas_ring import decode_pallas_ring  # noqa: E402
from lzma_tpu_torch.core.layout import ProbLayout  # noqa: E402
from lzma_tpu_torch.core.rangecoder import CorruptStreamError  # noqa: E402
from lzma_tpu_torch.ops import cuda_decoder, cuda_ring  # noqa: E402
from lzma_tpu_torch.ops import device_decoder as tdd  # noqa: E402


def _payloads(seed, n=4, size=1536):
    rng = np.random.default_rng(seed)
    bench = generate_bench_data(n * size)
    out = [bench[i * size:(i + 1) * size] for i in range(n - 1)]
    out.append(rng.integers(0, 256, size // 4, dtype=np.uint8).tobytes())
    return out


def _pack(streams):
    max_in = 1 << (max(max(len(s) for s in streams), 16) - 1).bit_length()
    comp = np.zeros((len(streams), max_in), np.uint8)
    for i, s in enumerate(streams):
        comp[i, :len(s)] = np.frombuffer(s, np.uint8)
    return comp, np.asarray([len(s) for s in streams], np.int32)


def _torch_fsm(comp, lens, sizes, params, max_out, preset=None):
    out, ok, pos = tdd._decode_fsm(
        torch.from_numpy(comp), torch.from_numpy(lens),
        torch.from_numpy(np.asarray(sizes, np.int32)), params.dict_size,
        params.lc, params.lp, params.pb, max_out,
        preset=None if preset is None else torch.frombuffer(
            bytearray(preset), dtype=torch.uint8))
    return out.numpy(), ok.numpy(), pos.numpy()


def _jax_fsm(comp, lens, sizes, params, max_out, preset=None):
    out, ok, _, pos = jdd._decode_fsm(
        jnp.asarray(comp), jnp.asarray(lens), jnp.asarray(np.asarray(sizes, np.int32)),
        np.int64(params.dict_size), params.lc, params.lp, params.pb, max_out,
        preset=None if preset is None else jnp.asarray(
            np.frombuffer(preset, np.uint8)))
    return np.asarray(out), np.asarray(ok), np.asarray(pos)


def _ring(comp, lens, sizes, params, max_out, preset=None):
    out, ok, _ = decode_pallas_ring(
        jnp.asarray(comp.astype(np.int32)), jnp.asarray(lens),
        jnp.asarray(np.asarray(sizes, np.int32)), params.dict_size, params.lc,
        params.lp, params.pb, max_out, interpret=True, stage_input=False,
        preset=None if preset is None else jnp.asarray(
            np.frombuffer(preset, np.uint8).astype(np.int32)))
    return np.asarray(out), np.asarray(ok)


def test_decode_fsm_matches_ring_kernel_and_jax_fsm():
    params = LzmaParams(dict_size=1 << 12)
    payloads = _payloads(seed=1)
    streams = [encode_stream(p, params, mode="greedy") for p in payloads]
    comp, lens = _pack(streams)
    sizes = [len(p) for p in payloads]
    out, ok, pos = _torch_fsm(comp, lens, sizes, params, 2048)
    r_out, r_ok = _ring(comp, lens, sizes, params, 2048)
    j_out, j_ok, j_pos = _jax_fsm(comp, lens, sizes, params, 2048)
    assert ok.all()
    np.testing.assert_array_equal(ok, r_ok)
    np.testing.assert_array_equal(out, r_out)
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_array_equal(pos, j_pos)
    for i, p in enumerate(payloads):
        assert out[i, :len(p)].tobytes() == p


def test_decode_fsm_preset_matches_ring_kernel():
    params = LzmaParams(dict_size=1 << 12)
    bench = generate_bench_data(4096)
    preset = bench[:1200]
    payloads = [bench[1200:2400], bench[2400:3200] + bench[:300]]
    streams = [encode_stream(p, params, preset=preset, mode="greedy")
               for p in payloads]
    comp, lens = _pack(streams)
    sizes = [len(p) + len(preset) for p in payloads]
    out, ok, _ = _torch_fsm(comp, lens, sizes, params, 4096, preset)
    r_out, r_ok = _ring(comp, lens, sizes, params, 4096, preset)
    assert ok.all() and r_ok.all()
    # the ring kernel materializes the coded bytes only: the payload
    # sits at out[:, P:] in both
    np.testing.assert_array_equal(out[:, len(preset):], r_out[:, len(preset):])
    for i, p in enumerate(payloads):
        assert out[i, len(preset):len(preset) + len(p)].tobytes() == p


@pytest.mark.parametrize("lc,lp,pb", [(0, 0, 0), (1, 2, 1), (4, 0, 4)])
def test_decode_batch_param_combos_match_jax(lc, lp, pb):
    params = LzmaParams(lc=lc, lp=lp, pb=pb, dict_size=1 << 10)
    payloads = _payloads(seed=lc + 3 * lp + 7 * pb, n=3, size=1024)
    streams = [encode_stream(p, params, mode="greedy") for p in payloads]
    sizes = [len(p) for p in payloads]
    got = tdd.decode_batch(streams, params, sizes, device="cpu")
    assert got == jdd.decode_batch(streams, params, sizes) == payloads


def _corrupt_cases():
    params = LzmaParams(dict_size=1 << 12)
    payload = generate_bench_data(700)
    good = encode_stream(payload, params, mode="greedy")
    flipped = bytearray(good)
    flipped[len(good) // 2] ^= 0x5A
    return params, payload, [
        (bytes(flipped), len(payload)),          # garbage mid-stream
        (good[: len(good) // 3], len(payload)),  # truncated: overrun
        (good, len(payload) + 50),               # decodes on into padding
        (good, len(payload) - 50),               # stops early, or overruns
    ]


def test_corrupt_streams_fail_exactly_like_jax():
    params, payload, cases = _corrupt_cases()
    comp, lens = _pack([s for s, _ in cases])
    sizes = [n for _, n in cases]
    # a dict smaller than the stream's distances fails the window check too
    small = LzmaParams(dict_size=16)
    for p in (params, small):
        out, ok, pos = _torch_fsm(comp, lens, sizes, p, 1024)
        j_out, j_ok, j_pos = _jax_fsm(comp, lens, sizes, p, 1024)
        assert not ok[:2].any()
        np.testing.assert_array_equal(ok, j_ok)
        np.testing.assert_array_equal(pos, j_pos)


def test_corrupt_stream_raises_through_decode_batch():
    params, payload, cases = _corrupt_cases()
    with pytest.raises(CorruptStreamError):
        tdd.decode_batch([cases[0][0]], params, [cases[0][1]], device="cpu")
    with pytest.raises(CorruptStreamError):
        tdd.decode_batch([b"\x00" * 8], params, [1 << 31], device="cpu")


def test_eos_lanes_and_cap():
    params = LzmaParams(dict_size=1 << 12, write_eos=True)
    payload = generate_bench_data(900)
    stream = encode_stream(payload, params, mode="greedy")
    assert tdd.decode_batch([stream], params, [-4096], device="cpu") == [payload]
    with pytest.raises(tdd.CapExceededError):
        tdd.decode_batch([stream], params, [-600], device="cpu")
    # a known-size lane treats the end marker as corruption
    comp, lens = _pack([stream])
    _, ok, pos = _torch_fsm(comp, lens, [len(payload) + 10], params, 1024)
    _, j_ok, j_pos = _jax_fsm(comp, lens, [len(payload) + 10], params, 1024)
    assert not ok[0] and not j_ok[0] and pos[0] == j_pos[0]


def test_zero_size_lanes_short_circuit():
    params = LzmaParams(dict_size=1 << 12)
    payload = b"lane-parallel " * 40
    stream = encode_stream(payload, params, mode="greedy")
    got = tdd.decode_batch([b"", stream, b""], params, [0, len(payload), 0],
                           device="cpu")
    assert got == [b"", payload, b""]
    assert tdd.decode_batch([], params, [], device="cpu") == []


def test_cuda_wrappers_take_the_plain_version_on_cpu():
    params = LzmaParams(dict_size=1 << 12)
    payloads = [b"plain version " * 30, generate_bench_data(400)]
    streams = [encode_stream(p, params, mode="greedy") for p in payloads]
    before = cuda_ring.LAUNCHES
    assert cuda_ring.decode_batch_cuda(
        streams, params, [len(p) for p in payloads], device="cpu") == payloads
    assert cuda_ring.LAUNCHES == before  # no kernel launch for CPU tensors


# ------------------------------------------------- K5's entry point
def _resident_vs_pallas(streams, params, sizes, preset=b""):
    got = cuda_decoder.decode_batch_resident(streams, params, sizes,
                                             preset=preset, device="cpu")
    want = decode_batch_pallas(streams, params, sizes, fallback=False,
                               preset=preset)
    assert got == want
    return got


def _mixed_payloads(rng):
    word = rng.integers(0, 256, 17, dtype=np.uint8).tobytes()
    return [b"a" * 400, (word * 40)[:500],
            rng.integers(0, 256, 300, dtype=np.uint8).tobytes(),
            (b"the quick brown fox " * 30)[:450]]


def test_resident_decode_matches_pallas_on_oracle_and_liblzma_streams():
    import lzma as pylzma

    params = LzmaParams(dict_size=1 << 16, fast_bytes=32)
    payloads = _mixed_payloads(np.random.default_rng(11))
    streams = [encode_stream(p, params) for p in payloads]
    assert _resident_vs_pallas(streams, params, [len(p) for p in payloads]) \
        == payloads
    params = LzmaParams(lc=3, lp=0, pb=2, dict_size=1 << 16)
    filt = [{"id": pylzma.FILTER_LZMA1, "preset": 6, "dict_size": 1 << 16}]
    payloads = [b"hello resident " * 40, bytes(range(256)) * 3]
    streams = [pylzma.compress(p, format=pylzma.FORMAT_ALONE, filters=filt)[13:]
               for p in payloads]
    # the known sizes stop these before liblzma's end marker
    assert _resident_vs_pallas(streams, params, [len(p) for p in payloads]) \
        == payloads


@pytest.mark.parametrize("lc,lp,pb", [(0, 2, 0), (1, 1, 1)])
def test_resident_decode_param_combos_match_pallas(lc, lp, pb):
    rng = np.random.default_rng(7 + lc * 9 + lp * 3 + pb)
    params = LzmaParams(lc=lc, lp=lp, pb=pb, dict_size=1 << 14, fast_bytes=16)
    payload = (rng.integers(0, 256, 23, dtype=np.uint8).tobytes() * 30)[:600]
    stream = encode_stream(payload, params)
    assert _resident_vs_pallas([stream], params, [len(payload)]) == [payload]


def test_resident_decode_corrupt_lane_raises_like_pallas():
    params = LzmaParams(dict_size=1 << 14)
    payload = np.random.default_rng(3).integers(0, 256, 300, dtype=np.uint8).tobytes()
    stream = bytearray(encode_stream(payload, params))
    stream[len(stream) // 2] ^= 0xFF
    with pytest.raises(ValueError):   # CorruptStreamError is a ValueError
        decode_batch_pallas([bytes(stream)], params, [len(payload)],
                            fallback=False)
    with pytest.raises(CorruptStreamError):
        cuda_decoder.decode_batch_resident([bytes(stream)], params,
                                           [len(payload)], device="cpu")


def test_resident_decode_zero_block_and_preset_batch():
    params = LzmaParams(dict_size=1 << 13, fast_bytes=64)
    payload = b"\x00" * 8192
    assert _resident_vs_pallas([encode_stream(payload, params)], params,
                               [len(payload)]) == [payload]
    rng = np.random.default_rng(23)
    params = LzmaParams(dict_size=1 << 14, fast_bytes=16)
    word = rng.integers(0, 256, 13, dtype=np.uint8).tobytes()
    payloads = [(word * 50)[: 200 + 17 * i] for i in range(4)]
    preset = (word * 10)[:100]
    streams = [encode_stream(p, params, preset=preset) for p in payloads]
    assert _resident_vs_pallas(streams, params, [len(p) for p in payloads],
                               preset=preset) == payloads


def test_resident_envelope_arithmetic():
    """What a lane needs: max_in + max_out + 2 x arena bytes, each part
    rounded up to 16 as the kernel lays them out."""
    lc3 = ProbLayout(3, 0, 2, pos_bits=2).size
    assert (ProbLayout(0, 0, 2, pos_bits=2).size, lc3) == (1942, 7318)
    assert cuda_decoder.resident_layout(16, 16, 8) == (16, 32, 48)
    assert cuda_decoder.resident_layout(17, 1, 1) == (16, 32, 64)
    # the bench512K config's 16 KiB blocks: about 40 KB a lane
    win, inp, need = cuda_decoder.resident_layout(1 << 13, 1 << 14, lc3)
    assert (win, inp, need) == (14640, 31024, 39216)
    # the main path's 256 KiB blocks and the lc8/lp4 arena do not fit a
    # block's 227 KB (232,448 B on the H100)
    assert cuda_decoder.resident_layout(1 << 17, 1 << 18, lc3)[2] > 232_448
    big = ProbLayout(8, 4, 2, pos_bits=2).size
    assert big == 3_146_902          # 6,293,804 B, rounded up to 6,293,808
    assert cuda_decoder.resident_layout(16, 16, big) == (6_293_808, 6_293_824,
                                                         6_293_840)
