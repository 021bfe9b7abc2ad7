"""lzma_tpu_torch's encoder back half against lzma_tpu's, on the CPU.

classify_tokens and lower_tokens are fed the JAX tokenizer's exact output
(through api.from_numpy); serialize, the plain version of the CUDA range
encoder, is held to the Pallas serializer in interpret mode and to the
XLA serializer.  The codec is integer-only: tolerance zero.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lzma_tpu.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu.core.layout import ProbLayout  # noqa: E402
from lzma_tpu.format.properties import LzmaParams  # noqa: E402
from lzma_tpu.ops import device_encoder as jde  # noqa: E402
from lzma_tpu.ops.device_matcher import tokenize as jax_tokenize  # noqa: E402
from lzma_tpu.ops.pallas_serializer import serialize_pallas  # noqa: E402
from lzma_tpu_torch.ops import cuda_serializer  # noqa: E402
from lzma_tpu_torch.ops import device_encoder as tde  # noqa: E402
from lzma_tpu_torch.ops.api import from_numpy  # noqa: E402


def _data(n_lanes, max_n, seed):
    rng = np.random.default_rng(seed)
    bench = np.frombuffer(generate_bench_data(n_lanes * max_n), np.uint8)
    data = bench.reshape(n_lanes, max_n).copy()
    data[-1, max_n // 2:] = rng.integers(0, 256, max_n - max_n // 2)
    lens = np.full(n_lanes, max_n, np.int32)
    lens[1] = max_n - 37
    return data, lens


def _jax_tokens(data, lens, fb=32, k=4):
    tok = jax.vmap(lambda d, n: jax_tokenize(d, n, data.shape[1], fb, k))(
        jnp.asarray(data), jnp.asarray(lens))
    return tok[:4]


@pytest.mark.parametrize("lc,lp,pb", [(3, 0, 2), (0, 0, 0), (1, 2, 1)])
def test_classify_and_lower_match_jax(lc, lp, pb):
    data, lens = _data(4, 1024, seed=lc + lp + pb)
    toks = _jax_tokens(data, lens)
    dj = jnp.asarray(data)
    meta = jde.classify_tokens(dj, *toks)
    max_bits = 10 * data.shape[1] + 128
    ctx, bits, total = jde.lower_tokens(dj, meta, *toks, lc, lp, pb, max_bits)

    t_data, *t_toks = from_numpy(data, *(np.asarray(t) for t in toks),
                                 device="cpu")
    t_meta = tde.classify_tokens(t_data, *t_toks)
    for name, r, g in zip(("kind", "rep_idx", "state", "match_mode",
                           "match_byte", "prev_byte", "lit_byte"), meta, t_meta):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    t_ctx, t_bits, t_total = tde.lower_tokens(t_data, t_meta, *t_toks, lc, lp,
                                              pb, max_bits)
    np.testing.assert_array_equal(t_total.numpy(), np.asarray(total))
    np.testing.assert_array_equal(t_ctx.numpy(), np.asarray(ctx))
    np.testing.assert_array_equal(t_bits.numpy(), np.asarray(bits))


def test_eos_marker_token_lowers_like_jax():
    # the end marker (distance 0xFFFFFFFF, slot 63) wraps int32 in the
    # reference's lowering; the port must reproduce it bit for bit
    data, lens = _data(2, 512, seed=9)
    t_pos, t_len, t_dist, t_valid, ntok = jax.vmap(
        lambda d, n: jax_tokenize(d, n, 512, 32, 4))(jnp.asarray(data),
                                                     jnp.asarray(lens))
    toks = jde._append_eos_tokens(t_pos, t_len, t_dist, t_valid, ntok,
                                  jnp.asarray(lens))
    dj = jnp.asarray(np.pad(data, ((0, 0), (0, 1))))
    meta = jde.classify_tokens(dj, *toks)
    ctx, bits, total = jde.lower_tokens(dj, meta, *toks, 3, 0, 2, 10 * 513 + 128)
    t_data, *t_toks = from_numpy(np.asarray(dj), *(np.asarray(t) for t in toks),
                                 device="cpu")
    t_meta = tde.classify_tokens(t_data, *t_toks)
    t_ctx, t_bits, t_total = tde.lower_tokens(t_data, t_meta, *t_toks, 3, 0, 2,
                                              10 * 513 + 128)
    np.testing.assert_array_equal(t_total.numpy(), np.asarray(total))
    np.testing.assert_array_equal(t_ctx.numpy(), np.asarray(ctx))
    np.testing.assert_array_equal(t_bits.numpy(), np.asarray(bits))


def _bit_streams(n_lanes=4, max_n=2048, seed=0, lc=3, lp=0, pb=2):
    """The (ctx, bit) streams of tests/test_pallas_serializer.py."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(0, 256, int(rng.integers(3, 30)), dtype=np.uint8).tobytes()
             for _ in range(32)]
    data = np.zeros((n_lanes, max_n), dtype=np.uint8)
    for i in range(n_lanes):
        b = bytearray()
        while len(b) < max_n:
            b.extend(words[int(rng.integers(0, 32))])
        data[i] = np.frombuffer(bytes(b[:max_n]), dtype=np.uint8)
    dj = jnp.asarray(data)
    lens = jnp.full((n_lanes,), max_n, jnp.int32)
    t_pos, t_len, t_dist, t_valid, _ = jax.vmap(
        lambda d, n: jax_tokenize(d, n, max_n, 32, 2))(dj, lens)
    meta = jde.classify_tokens(dj, t_pos, t_len, t_dist, t_valid)
    ctx, bits, totals = jde.lower_tokens(
        dj, meta, t_pos, t_len, t_dist, t_valid, lc, lp, pb, 10 * max_n + 128)
    layout = ProbLayout(lc, lp, pb, pos_bits=pb)
    return ctx, bits, totals, layout.size, max_n + max_n // 4 + 128


@pytest.mark.parametrize("seed", [0, 3])
def test_serialize_matches_pallas_interpret_and_xla(seed):
    ctx, bits, totals, arena, mo = _bit_streams(seed=seed)
    p_out, p_lens, consumed = serialize_pallas(ctx, bits, totals, arena, mo,
                                               interpret=True)
    x_out, x_lens = jde.serialize(ctx, bits, totals, arena, mo)
    t_ctx, t_bits, t_tot = from_numpy(*(np.asarray(a) for a in (ctx, bits, totals)),
                                      device="cpu")
    out, lens = tde.serialize(t_ctx, t_bits, t_tot, arena, mo)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(p_lens))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(x_lens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(x_out))
    po = np.asarray(p_out)
    for i in range(po.shape[0]):
        n = int(lens[i])
        assert out[i, :n].numpy().tobytes() == po[i, :n].tobytes()


def test_serialize_padding_and_cpu_wrappers():
    # ctx -3 inside totals is a step that codes nothing (the Pallas pad)
    ctx, bits, totals, arena, mo = _bit_streams(seed=0)
    ctx = np.asarray(ctx).copy()
    ctx[0, 5:9] = -3
    x_out, x_lens = jde.serialize(jnp.asarray(ctx), bits, totals, arena, mo)
    t_ctx, t_bits, t_tot = from_numpy(ctx, np.asarray(bits), np.asarray(totals),
                                      device="cpu")
    before = cuda_serializer.LAUNCHES
    out, lens, consumed = cuda_serializer.serialize_cuda(t_ctx, t_bits, t_tot,
                                                         arena, mo)
    assert cuda_serializer.LAUNCHES == before  # CPU tensors: plain version
    np.testing.assert_array_equal(out.numpy(), np.asarray(x_out))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(x_lens))
    np.testing.assert_array_equal(consumed.numpy(), np.asarray(totals))
    # an output buffer too small for a lane: the checked wrapper raises
    with pytest.raises(RuntimeError, match="passed"):
        cuda_serializer.serialize_checked(t_ctx, t_bits, t_tot, arena, 16)


def test_encode_batch_matches_jax_pallas_route():
    params = LzmaParams(dict_size=1 << 12)
    data, lens = _data(3, 1024, seed=21)
    blocks = [data[i, :lens[i]].tobytes() for i in range(3)]
    ref = jde.encode_batch(blocks, params, use_pallas=True)
    assert tde.encode_batch(blocks, params, device="cpu") == ref
    assert tde.encode_batch([], params, device="cpu") == []


def test_encoder_rejects_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        tde.encode_batch([b"abc"], LzmaParams(), parse="optimal:lists2",
                         device="cpu")
    # the optimal parse, preset priming and the EOS marker are ported now
    blocks = [generate_bench_data(700), b"abcabcabd" * 20]
    assert tde.encode_batch([b"abc" * 9], LzmaParams(write_eos=True),
                            parse="optimal", write_eos=True, device="cpu") == \
        jde.encode_batch([b"abc" * 9], LzmaParams(write_eos=True),
                         parse="optimal", write_eos=True)
    for kw in (dict(parse="optimal"), dict(preset=b"abcab" * 30)):
        assert tde.encode_batch(blocks, LzmaParams(), device="cpu", **kw) == \
            jde.encode_batch(blocks, LzmaParams(), use_pallas=True, **kw)
    with pytest.raises(ValueError):
        tde.clamp_fb(4)
    data, lens = _data(2, 256, seed=2)
    t_data, t_lens = from_numpy(data, lens, device="cpu")
    tok = tde.tokenize(t_data, t_lens, 256, 32)
    meta = tde.classify_tokens(t_data, *tok[:4])
    with pytest.raises(ValueError, match="exceed"):
        tde.lower_tokens(t_data, meta, *tok[:4], 3, 0, 2, max_bits=64)
