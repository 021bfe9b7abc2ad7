"""The port's hybrid encode against lzma_tpu's, on the CPU.

The host encoder (lzma_tpu_torch/runtime/src/host_encoder.cpp, the
encoder half of the JAX package's C++ runtime) must write the bytes of
lzma_tpu.runtime.native on the same inputs; the card's half (the
multi-tier candidate lists, their packing) must give the arrays of
lzma_tpu.ops.device_matcher; the hybrid containers, the front door's
backend="hybrid" and the CLI's -backendhybrid must write what the JAX
package writes.  Tests that need g++ skip without it.
"""

import os
import subprocess

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import lzma_tpu  # noqa: E402
import lzma_tpu_torch  # noqa: E402
from lzma_tpu import cli as jcli  # noqa: E402
from lzma_tpu.bench.corpus import text_part  # noqa: E402
from lzma_tpu.bench.datagen import generate_bench_data  # noqa: E402
from lzma_tpu.format.properties import LzmaParams as JParams  # noqa: E402
from lzma_tpu.ops import device_matcher as jm  # noqa: E402
from lzma_tpu.ops import hybrid as jh  # noqa: E402
from lzma_tpu.runtime import native as jnative  # noqa: E402
from lzma_tpu_torch import cli as tcli  # noqa: E402
from lzma_tpu_torch.format.properties import LzmaParams  # noqa: E402
from lzma_tpu_torch.ops import api as tapi  # noqa: E402
from lzma_tpu_torch.ops import device_matcher as tm  # noqa: E402
from lzma_tpu_torch.ops import hybrid as th  # noqa: E402
from lzma_tpu_torch.runtime import native  # noqa: E402


@pytest.fixture(scope="module")
def host():
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain")


def _jp(p):
    return JParams(lc=p.lc, lp=p.lp, pb=p.pb, dict_size=p.dict_size,
                   fast_bytes=p.fast_bytes, match_finder=p.match_finder,
                   write_eos=p.write_eos)


DATA = generate_bench_data(40_000)
TEXT = text_part()[:24_000]


# ------------------------------------------------------- the host encoder
def test_host_library_is_its_own(host):
    """The host encoder builds into the port's _build under its own name,
    and its source compiles with -Wall and no warning (the decoder half
    of the original is gone, and nothing it used is left unused)."""
    path = native.library_path()
    assert os.path.dirname(path).endswith(os.path.join("lzma_tpu_torch", "_build"))
    assert os.path.basename(path) != "liblzma_tpu_native.so"
    assert os.path.exists(path)
    flags = [f for f in native.CXXFLAGS if f not in ("-shared", "-fPIC")]
    done = subprocess.run(["g++", *flags, "-Werror", "-fsyntax-only",
                           native.SRC], capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr


@pytest.mark.parametrize("lc,lp,pb,fb,mf", [
    (3, 0, 2, 32, "bt4"), (0, 2, 0, 5, "bt2"), (4, 1, 1, 273, "hc4"),
    (8, 4, 4, 64, "fast4")])
def test_encode_stream_matches_jax(host, lc, lp, pb, fb, mf):
    p = LzmaParams(lc=lc, lp=lp, pb=pb, dict_size=1 << 14, fast_bytes=fb,
                   match_finder=mf)
    data = TEXT[:6000] + DATA[:6000]
    assert native.encode_stream(data, p) == jnative.encode_stream(data, _jp(p))


def _lanes(data, bs):
    n = -(-len(data) // bs)
    arr = np.zeros((n, bs), np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        b = data[i * bs:(i + 1) * bs]
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return arr, lens


@pytest.mark.parametrize("lc,lp,pb,preset,first", [
    (3, 0, 2, 0, False), (0, 2, 1, 700, False), (5, 0, 3, 900, True)])
def test_encode_token_blocks_matches_jax(host, lc, lp, pb, preset, first):
    bs = 4096
    arr, lens = _lanes(DATA[:3 * bs + 1000], bs)
    pre = TEXT[:preset]

    def tokens(a, ln, start):
        primed = np.concatenate([np.broadcast_to(
            np.frombuffer(pre[:start], np.uint8), (len(ln), start)), a], axis=1)
        tp, tl, td, _, nt = tm.tokenize(torch.from_numpy(primed),
                                        torch.from_numpy(ln + start), 1 << 14,
                                        32, start=start)
        nt = nt.numpy().astype(np.int64)
        keep = np.arange(tp.shape[1])[None, :] < nt[:, None]
        return (tp.numpy() - start)[keep], tl.numpy()[keep], td.numpy()[keep], nt

    if pre and not first:   # v2: block 0 is the preset's source, coded plain
        parts = [tokens(arr[:1], lens[:1], 0), tokens(arr[1:], lens[1:], preset)]
        tp, tl, td, nt = (np.concatenate(x) for x in zip(*parts))
    else:
        tp, tl, td, nt = tokens(arr, lens, len(pre))
    offs = np.concatenate([[0], np.cumsum(nt)[:-1]])
    args = (arr.reshape(-1), bs, lc, lp, pb, tp, tl, td, offs, nt)
    kw = dict(num_threads=2, preset=pre, preset_first=first)
    assert native.encode_token_blocks(*args, **kw) == \
        jnative.encode_token_blocks(*args, **kw)


@pytest.mark.parametrize("lc,lp,pb,fb,preset,first", [
    (3, 0, 2, 32, 0, False), (1, 1, 0, 5, 600, False),
    (3, 0, 2, 273, 800, True), (0, 4, 4, 128, 0, False)])
def test_encode_candidate_blocks_matches_jax(host, lc, lp, pb, fb, preset,
                                             first):
    bs = 4096
    data = TEXT[:2 * bs + 1500]
    arr, lens = _lanes(data, bs)
    pre = DATA[:preset]
    plen = len(pre)
    primed = np.concatenate([np.broadcast_to(np.frombuffer(pre, np.uint8),
                                             (len(lens), plen)), arr], axis=1)
    n_pos = lens + plen
    if plen and not first:   # v2: block 0 searches plain
        primed[0] = np.concatenate([arr[0], np.zeros(plen, np.uint8)])
        n_pos[0] = lens[0]
    cl, cd, cn = tm.find_match_lists_rmq(
        torch.from_numpy(primed), torch.from_numpy(n_pos), 1 << 14, fb,
        **th.DEFAULT_TIERS)
    flat = th._flatten_lists(cl.numpy(), cd.numpy(), cn.numpy(), n_pos)
    args = (arr.reshape(-1), bs, lc, lp, pb, 1 << 14, fb, *flat)
    kw = dict(num_threads=2, preset=pre, preset_first=first,
              total_len=len(data))
    assert native.encode_candidate_blocks(*args, **kw) == \
        jnative.encode_candidate_blocks(*args, **kw)


# -------------------------------------------------- the card's list search
def _lz_mix(seed, size):
    rng = np.random.default_rng(seed)
    out = bytearray(rng.integers(0, 256, 50, dtype=np.uint8).tobytes())
    while len(out) < size:
        if rng.integers(0, 2):
            s = int(rng.integers(0, len(out)))
            out.extend(out[s:s + int(rng.integers(2, 400))])
        else:
            out.append(int(rng.integers(0, 256)))
    return bytes(out[:size])


LIST_CASES = {
    "default-tiers-fb32": (th.DEFAULT_TIERS, 32),
    "k4-2-k8-1-fb16": (dict(k4=2, k8=1, k16=0), 16),
    "rank-tuple-fb128": (dict(k4=(1, 2, 4, 8), k8=2, k32=(1, 3)), 128),
    "default-tiers-fb128": (th.DEFAULT_TIERS, 128),
}


@pytest.mark.parametrize("name", sorted(LIST_CASES))
def test_find_match_lists_rmq_matches_jax(name):
    tiers, fb = LIST_CASES[name]
    w = 2048
    arr = np.stack([np.frombuffer(_lz_mix(5, w), np.uint8),
                    np.frombuffer(TEXT[:w], np.uint8)])
    lens = np.array([w, w - 333], np.int32)
    ref = jax.vmap(lambda d, n: jm.find_match_lists_rmq(
        d, n, jnp.int32(1500), fb, **tiers))(jnp.asarray(arr), jnp.asarray(lens))
    got = tm.find_match_lists_rmq(torch.from_numpy(arr), torch.from_numpy(lens),
                                  1500, fb, **tiers)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy()), name


def test_rmq_search_keeps_its_dp_defaults():
    """The optimal parse's search is _rmq_search's defaults: DP_TIERS cut to
    DP_M_CAP by round-robin priority, as find_match_lists_rmq with them."""
    arr = np.frombuffer(DATA[:2048], np.uint8).reshape(1, -1).copy()
    lens = np.array([2000], np.int32)
    d, n = torch.from_numpy(arr), torch.from_numpy(lens)
    a = tm._rmq_search(d, n, 2048, 32)[:3]
    b = tm.find_match_lists_rmq(d, n, 2048, 32, m_cap=tm.DP_M_CAP,
                                m_cap_order="rr", **tm.DP_TIER_KS)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        tm.tier_ranks(dict(k5=1))


def test_pack_match_lists_equivalence_and_overflow(host):
    """pack_match_lists equals JAX's, flattens to _flatten_lists' arrays
    at a generous cap, and clamps counts at a tiny cap with offsets that
    still match the buffers: the container round-trips
    (tests/test_hybrid_optimal.py's check, on the port)."""
    bs = 1 << 12
    data = generate_bench_data(bs * 3)
    arr = np.frombuffer(data, np.uint8).reshape(3, bs)
    lens = np.full(3, bs, np.int32)
    cl, cd, cn = tm.find_match_lists_rmq(torch.from_numpy(arr.copy()),
                                         torch.from_numpy(lens), bs, 32,
                                         **th.DEFAULT_TIERS)
    ref = th._flatten_lists(cl.numpy(), cd.numpy(), cn.numpy(), lens)
    jl = jax.vmap(lambda d, n: jm.find_match_lists_rmq(
        d, n, jnp.int32(bs), 32, **th.DEFAULT_TIERS))(jnp.asarray(arr),
                                                       jnp.asarray(lens))
    for cap in (3 * bs, bs // 4):
        packed = tm.pack_match_lists(cl, cd, cn, cap)
        want = jax.vmap(lambda a, b, c: jm.pack_match_lists(a, b, c, cap))(*jl)
        for w, g in zip(want, packed):
            assert np.array_equal(np.asarray(w), g.numpy()), cap
        fl, fd, ce = (x.numpy() for x in packed)
        got = th._flatten_packed(fl, fd, ce, lens)
        if cap == 3 * bs:
            for r, g, name in zip(ref, got, ("lens", "dists", "offs", "base")):
                assert np.array_equal(r, g), name
            continue
        assert (ce.sum(axis=1) <= cap).all() and ce.sum() < cn.sum()
        payload, sizes = native.encode_candidate_blocks(
            arr.reshape(-1), bs, 3, 0, 2, bs, 32, *got, num_threads=1,
            total_len=len(data))
        blob = th._container(LzmaParams(dict_size=bs, fast_bytes=32), bs,
                             data, 3, 0, b"", sizes, payload)
        assert lzma_tpu.decompress(blob) == data


# ------------------------------------------------------ hybrid containers
LAZY_CASES = {
    "plain": (DATA[:7000], dict()),
    "preset": (DATA[:7000], dict(preset_len=500)),
    "dictionary": (DATA[:7000], dict(dictionary=TEXT[-1000:])),
    "single-block": (b"q", dict()),
}


@pytest.mark.parametrize("name", sorted(LAZY_CASES))
def test_encode_blocks_hybrid_matches_jax_and_the_device_encoder(host, name):
    data, kw = LAZY_CASES[name]
    p = LzmaParams(dict_size=1 << 12, fast_bytes=16)
    got = th.encode_blocks_hybrid(data, p, block_size=2048, device="cpu", **kw)
    assert got == jh.encode_blocks_hybrid(data, _jp(p), block_size=2048, **kw)
    # the same tokens through the port's own device serializer (a stored
    # dictionary's stream is the host's optimal parse in the hybrid)
    if "dictionary" not in kw:
        assert got == tapi.encode_blocks(data, p, block_size=2048,
                                         device="cpu", **kw)
    assert lzma_tpu.decompress(got) == data


OPT_CASES = {
    "partial-last-block": (DATA[:9500], LzmaParams(dict_size=1 << 14), dict()),
    "v2-preset": (TEXT[:9000], LzmaParams(dict_size=1 << 15), dict(preset_len=900)),
    "v3-dictionary": (TEXT[:9000], LzmaParams(lc=1, lp=1, pb=0),
                      dict(dictionary=DATA[-1500:])),
    "tiers": (DATA[:9000], LzmaParams(), dict(tiers=dict(k4=(1, 2, 4), k16=2))),
    "fb128": (TEXT[:9000], LzmaParams(fast_bytes=128), dict()),
    "empty": (b"", LzmaParams(), dict()),
}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_encode_blocks_hybrid_optimal_matches_jax(host, name):
    data, p, kw = OPT_CASES[name]
    got = th.encode_blocks_hybrid_optimal(data, p, block_size=4096,
                                          device="cpu", **kw)
    assert got == jh.encode_blocks_hybrid_optimal(data, _jp(p),
                                                  block_size=4096, **kw)
    assert lzma_tpu.decompress(got) == data


def test_grouping_changes_no_output(host, monkeypatch):
    data = DATA[:9500]
    p = LzmaParams(dict_size=1 << 13)
    whole = th.encode_blocks_hybrid_optimal(data, p, block_size=2048,
                                            device="cpu")
    monkeypatch.setattr(th, "_group_lanes", lambda n, width, M, device: 2)
    assert th.encode_blocks_hybrid_optimal(data, p, block_size=2048,
                                           device="cpu") == whole


def test_encode_stream_hybrid_optimal_matches_jax(host):
    for data, p in ((TEXT[:7000], LzmaParams(fast_bytes=64)),
                    (b"abc", LzmaParams())):
        got = th.encode_stream_hybrid_optimal(data, p, device="cpu")
        assert got == jh.encode_stream_hybrid_optimal(data, _jp(p))
        assert jnative.decode_stream(got, _jp(p), len(data)) == data


def test_front_door_hybrid_matches_jax(host):
    data = TEXT[:6000]
    p = LzmaParams(dict_size=1 << 14)
    for kw in (dict(), dict(train_dict=400), dict(preset_len=300)):
        ref = lzma_tpu.compress(data, _jp(p), container="lztb",
                                backend="hybrid", block_size=2048, **kw)
        got = lzma_tpu_torch.compress(data, p, backend="hybrid",
                                      block_size=2048, device="cpu", **kw)
        assert got == ref
        assert lzma_tpu.decompress(got) == data
    with pytest.raises(ValueError):
        lzma_tpu_torch.compress(data, backend="hybrid", container="alone",
                                device="cpu")


CLI_CASES = {
    "optimal": ["e", "-bs2048"],
    "lazy-a1": ["e", "-bs2048", "-a1", "-d12"],
    "lazy-a0-preset": ["e", "-bs2048", "-a0", "-ps500"],
    "optimal-td-mf-t": ["e", "-bs2048", "-td300", "-mfhc4", "-fb64", "-t2"],
    "optimal-tune-tdauto": ["e", "-bs2048", "-tune", "-tdauto"],
}


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_cli_backendhybrid_files_match_jax(host, name, tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(TEXT[:5000])
    j_out, t_out, back = (tmp_path / x for x in ("j", "t", "back"))
    args = [*CLI_CASES[name], "-backendhybrid"]
    assert jcli.main([*args, str(src), str(j_out)]) == 0
    assert tcli.main([*args, "-q", str(src), str(t_out)], device="cpu") == 0
    assert t_out.read_bytes() == j_out.read_bytes()
    assert tcli.main(["d", "-backendhybrid", "-q", str(t_out), str(back)],
                     device="cpu") == 0
    assert back.read_bytes() == src.read_bytes()


def test_cli_backendhybrid_refusals(host, tmp_path, capsys):
    src = tmp_path / "in.bin"
    src.write_bytes(TEXT[:500])
    out = str(tmp_path / "o")
    for args in (["e", "-backendhybrid"], ["e", "-backendhybrid", "-bs256", "-eos"],
                 ["e", "-backendhybrid", "-tune", "-tdauto"]):
        assert tcli.main([*args, str(src), out], device="cpu") == 1
        assert "error:" in capsys.readouterr().out
