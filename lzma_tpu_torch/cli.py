"""LzmaAlone-compatible command line on the device codec.

Port of ``lzma_tpu/cli.py`` on its ``-backendtpu`` and ``-backendhybrid``
routes: the reference's switch grammar (LzmaAlone.java:42-134), the same
defaults (dict 2^23, fb 128, lc3 lp0 pb2) and the `.lzma` and LZTB files
of the JAX package, byte for byte.

    python -m lzma_tpu_torch e [switches] in out    encode
    python -m lzma_tpu_torch d [switches] in out    decode
    python -m lzma_tpu_torch b [switches] [passes]  benchmark

`e` writes one `.lzma` stream (``ops.api.encode_alone``; ``-eos`` ends
it with the marker), or with ``-bs{N}`` an LZTB container of N-byte
blocks (``ops.api.encode_blocks``, the lazy parse; ``-ps{N}`` a shared
preset, LZTB v2; ``-td{N}`` a trained N-byte dictionary, LZTB v3,
``-tdauto`` one sized against its storage cost).  ``-tune`` picks
lc/lp/pb by measured cost on the input's first bytes; every encode route
reads the tuned values.  ``-backendhybrid -bs{N}`` writes the container
by the hybrid encode (the card's search, the host's coder,
``ops.hybrid``): ``-a2`` (the default) the candidate lists and the
optimal parse, ``-a0``/``-a1`` the lazy tokens; ``-mf`` picks the match
finder of a trained dictionary's stream and ``-t{N}`` the host threads.
`d` reads either container on the device.  `b` is the reference's
rating loop (``bench.harness``, LzmaBench.java): `passes` (10 unless
given) encodes of dict + 2 MiB of benchmark data (dict 2 MiB unless
``-d``), each decoded twice and CRC-checked; ``-backendtpu`` rates the
device codec's one-lane stream (``ops.api.encode_stream`` and
``decode_stream``), ``-backendhybrid`` the hybrid's
(``ops.hybrid.encode_stream_hybrid_optimal``), decoded on the card.
``-backendtpu`` (the default) names the device codec, which takes none
of ``-a``, ``-mf`` and ``-t``; the host codecs' backends
(``-backendscalar``, ``-backendnative``) end in "error: ..." and exit 1,
as does any failure, a missing CUDA device among them.
`main(device="cpu")` runs the plain versions instead of the card's
kernels.
"""

from __future__ import annotations

import sys

from .format.properties import LzmaParams

BANNER = "\nLZMA (torch) 0.1 — the device codec of lzma_tpu on CUDA\n"

HELP = """
Usage:  lzma_tpu_torch <e|d|b> [<switches>...] inputFile outputFile
  e: encode file
  d: decode file
  b: Benchmark [passes]
<Switches>
  -d{N}:  set dictionary - [0,28], default: 23 (8MB; b: 21)
  -fb{N}: set number of fast bytes - [5, 273], default: 128
  -lc{N}: set number of literal context bits - [0, 8], default: 3
  -lp{N}: set number of literal pos bits - [0, 4], default: 0
  -pb{N}: set number of pos bits - [0, 4], default: 2
  -eos:   write End Of Stream marker
  -mf{MF_ID}: match finder of a trained dictionary's stream (hybrid):
          [bt2, bt4, hc4, fast4], default: bt4
  -backend{B}: tpu | hybrid (default: tpu, the device codec; hybrid =
          the card's match search + the host's coder, encode with
          -bs{N}; -a2 [default] the candidate lists + the host optimal
          parse, -a0/-a1 the lazy device tokenizer; b rates its stream
          and decodes it on the card)
  -bs{N}: block size (bytes) -> block-parallel LZTB container
  -ps{N}: shared preset-dictionary bytes for block-parallel mode (LZTB v2)
  -td{N}: train an N-byte dictionary from the input and store it in the
          container, priming every block (LZTB v3); -tdauto auto-sizes
          the dictionary against its storage cost
  -tune:  pick lc/lp/pb by measured cost on the input's first bytes
  -t{N}:  host threads of the hybrid encode
  -q:     quiet
"""

#: the training sample's size (lzma_tpu.parallel.filestream.DEFAULT_BATCH_BYTES)
TRAIN_SAMPLE_BYTES = 64 << 20


class CommandLine:
    """Switch parser with the reference's grammar (lzma_tpu.cli.CommandLine).
    A backend of the host codecs parses, as there, and is recorded in
    `unsupported` for the dispatch to refuse; ``-a``, ``-mf`` and ``-t``
    are recorded in `hybrid_only`, which the device codec refuses."""

    def __init__(self):
        self.command = None
        self.num_passes = 10
        self.dict_size = 1 << 23
        self.dict_defined = False
        self.lc, self.lp, self.pb = 3, 0, 2
        self.fb = 128
        self.eos = False
        self.block_size = 0
        self.preset_len = 0
        self.train_dict = 0
        self.tune = False
        self.backend = "tpu"
        self.algorithm = 2
        self.match_finder = "bt4"
        self.threads = 0
        self.quiet = False
        self.unsupported: list[str] = []
        self.hybrid_only: list[str] = []
        self.in_file = None
        self.out_file = None

    def parse_switch(self, s: str) -> bool:
        try:
            if s.startswith("backend"):
                backend = s[7:]
                if backend not in ("scalar", "native", "tpu", "hybrid"):
                    return False
                if backend in ("scalar", "native"):
                    self.unsupported.append(f"-backend{backend}")
                else:
                    self.backend = backend
            elif s.startswith("bs"):
                self.block_size = int(s[2:])
            elif s.startswith("d"):
                self.dict_size = 1 << int(s[1:])
                self.dict_defined = True
            elif s.startswith("fb"):
                self.fb = int(s[2:])
            elif s.startswith("a"):
                self.algorithm = int(s[1:])
                self.hybrid_only.append("-a")
            elif s.startswith("lc"):
                self.lc = int(s[2:])
            elif s.startswith("lp"):
                self.lp = int(s[2:])
            elif s.startswith("pb"):
                self.pb = int(s[2:])
            elif s.startswith("ps"):
                self.preset_len = int(s[2:])
            elif s.startswith("eos"):
                self.eos = True
            elif s.startswith("mf"):
                mf = "bt4" if s[2:] == "bt4b" else s[2:]   # bt4b: alias
                if mf not in ("bt2", "bt4", "hc4", "fast4"):
                    return False
                self.match_finder = mf
                self.hybrid_only.append("-mf")
            elif s == "tune":
                self.tune = True
            elif s.startswith("td"):
                if s[2:] == "auto":
                    self.train_dict = "auto"
                else:
                    self.train_dict = int(s[2:])
                    if self.train_dict < 1:
                        return False
            elif s.startswith("t"):
                self.threads = int(s[1:])
                self.hybrid_only.append("-t")
            elif s.startswith("q"):
                self.quiet = True
            else:
                return False
            return True
        except ValueError:
            return False

    def parse(self, args) -> bool:
        pos = 0
        switch_mode = True
        for s in args:
            if not s:
                return False
            if switch_mode:
                if s == "--":
                    switch_mode = False
                    continue
                if s[0] == "-":
                    if not s[1:] or not self.parse_switch(s[1:].lower()):
                        return False
                    continue
            if pos == 0:
                cmd = s.lower()
                if cmd not in ("e", "d", "b"):
                    return False
                self.command = cmd
            elif pos == 1:
                if self.command == "b":
                    try:
                        self.num_passes = int(s)
                    except ValueError:
                        return False
                    if self.num_passes < 1:
                        return False
                else:
                    self.in_file = s
            elif pos == 2:
                self.out_file = s
            else:
                return False
            pos += 1
        return True

    def params(self) -> LzmaParams:
        return LzmaParams(lc=self.lc, lp=self.lp, pb=self.pb,
                          dict_size=self.dict_size, fast_bytes=self.fb,
                          match_finder=self.match_finder, write_eos=self.eos)


def main(argv=None, device="cuda") -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    print(BANNER)
    if not args:
        print(HELP)
        return 0
    cmd = CommandLine()
    if not cmd.parse(args):
        print("\nIncorrect command")
        return 1
    try:
        return _dispatch(cmd, device)
    except (OSError, ValueError, RuntimeError) as e:
        # the contract is "error: ..." and exit 1, never a traceback
        # (CorruptStreamError is a ValueError, NotImplementedError a
        # RuntimeError)
        print(f"error: {e}")
        return 1


def _dispatch(cmd: CommandLine, device) -> int:
    import torch

    from .ops import api

    if cmd.unsupported:
        print(f"error: {', '.join(cmd.unsupported)} not supported: the port "
              "has the device codec and the hybrid")
        return 1
    if cmd.hybrid_only and cmd.backend != "hybrid":
        print(f"error: {', '.join(cmd.hybrid_only)} not supported by the "
              "device codec (-backendhybrid takes them)")
        return 1
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device: the device codec runs on the card")
        return 1
    if cmd.command == "b":
        return _benchmark(cmd, device)
    hybrid = cmd.command == "e" and cmd.backend == "hybrid"
    if hybrid and not cmd.block_size:
        print("error: -backendhybrid encodes the block container; pass -bs{N}")
        return 1
    if not cmd.in_file or not cmd.out_file:
        print(HELP)
        return 1
    if cmd.command == "e" and cmd.train_dict and not cmd.block_size:
        print("error: -td requires the block container (-bs{N})")
        return 1
    try:
        with open(cmd.in_file, "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"error: cannot read {cmd.in_file}: {e.strerror}")
        return 1
    if cmd.command == "e" and cmd.tune:
        # measured lc/lp/pb on the input's first bytes; every encode route
        # below reads the tuned values through cmd.params()
        from .utils.autotune import select_params

        tuned = select_params(data[:TRAIN_SAMPLE_BYTES], cmd.params(),
                              block_size=cmd.block_size or (1 << 20))
        cmd.lc, cmd.lp, cmd.pb = tuned.lc, tuned.lp, tuned.pb
        if not cmd.quiet:
            print(f"tuned: -lc{tuned.lc} -lp{tuned.lp} -pb{tuned.pb}")
    tag = "device"
    if cmd.command == "e":
        params = cmd.params().validated_for_encode()
        if cmd.block_size:
            dictionary = b""
            sample = data[:TRAIN_SAMPLE_BYTES]
            if cmd.train_dict == "auto":
                from .utils.dicttrain import select_dictionary

                dictionary = select_dictionary(sample, cmd.params(),
                                               block_size=cmd.block_size)
            elif cmd.train_dict:
                from .utils.dicttrain import train_dictionary

                dictionary = train_dictionary(sample, cmd.train_dict)
            kw = dict(block_size=cmd.block_size, preset_len=cmd.preset_len,
                      dictionary=dictionary, device=device)
            if hybrid:
                from .ops import hybrid as hyb

                if cmd.algorithm >= 2:
                    out = hyb.encode_blocks_hybrid_optimal(
                        data, params, num_threads=cmd.threads, **kw)
                    tag = "hybrid-optimal"
                else:
                    out = hyb.encode_blocks_hybrid(
                        data, params, num_threads=cmd.threads, **kw)
                    tag = "hybrid"
            else:
                out = api.encode_blocks(data, params, **kw)
        else:
            out = api.encode_alone(data, params, device=device)
    elif data[:4] == b"LZTB":
        out = api.decode_blocks(data, device=device)
    else:
        out = api.decode_alone(data, device=device)
    try:
        with open(cmd.out_file, "wb") as f:
            f.write(out)
    except OSError as e:
        print(f"error: cannot write {cmd.out_file}: {e.strerror}")
        return 1
    if not cmd.quiet:
        print(f"{cmd.command}: {len(data)} -> {len(out)} bytes [{tag}]")
    return 0


def _benchmark(cmd: CommandLine, device) -> int:
    """`b`: the rating loop on the device codec's one-lane stream, or with
    -backendhybrid on the hybrid's; both decoded on `device`."""
    from .bench.harness import run_benchmark

    dict_size = cmd.dict_size if cmd.dict_defined else (1 << 21)
    params = LzmaParams(dict_size=dict_size)
    encode_fn = None    # the harness's own: api.encode_stream on `device`
    if cmd.backend == "hybrid":
        from .ops.hybrid import encode_stream_hybrid_optimal
        from .runtime import native

        native.require("b -backendhybrid")   # before any pass, not after one

        def encode_fn(d):
            return encode_stream_hybrid_optimal(d, params, device=device)

    run_benchmark(cmd.num_passes, dict_size, params=params,
                  encode_fn=encode_fn, device=device)
    return 0
