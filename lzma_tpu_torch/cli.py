"""LzmaAlone-compatible command line on the device codec.

Port of ``lzma_tpu/cli.py``'s `e`/`d` commands on its ``-backendtpu``
route: the reference's switch grammar (LzmaAlone.java:42-134), the same
defaults (dict 2^23, fb 128, lc3 lp0 pb2) and the `.lzma` and LZTB
files of the JAX package, byte for byte.

    python -m lzma_tpu_torch e [switches] in out    encode
    python -m lzma_tpu_torch d [switches] in out    decode

`e` writes one `.lzma` stream (``ops.api.encode_alone``; ``-eos`` ends
it with the marker), or with ``-bs{N}`` an LZTB container of N-byte
blocks (``ops.api.encode_blocks``, the lazy parse; ``-ps{N}`` a shared
preset, LZTB v2; ``-td{N}`` a trained N-byte dictionary, LZTB v3).  `d`
reads either.  The device is the only backend (``-backendtpu`` names
it); the switches of the host codecs (other backends, ``-mf``, ``-a``,
``-t``, ``-tune``, ``-tdauto``) and the benchmark `b` end in
"error: ..." and exit 1, as does any failure.  `main(device="cpu")`
runs the plain versions instead of the card's kernels.
"""

from __future__ import annotations

import sys

from .format.properties import LzmaParams

BANNER = "\nLZMA (torch) 0.1 — the device codec of lzma_tpu on CUDA\n"

HELP = """
Usage:  lzma_tpu_torch <e|d> [<switches>...] inputFile outputFile
  e: encode file
  d: decode file
<Switches>
  -d{N}:  set dictionary - [0,28], default: 23 (8MB)
  -fb{N}: set number of fast bytes - [5, 273], default: 128
  -lc{N}: set number of literal context bits - [0, 8], default: 3
  -lp{N}: set number of literal pos bits - [0, 4], default: 0
  -pb{N}: set number of pos bits - [0, 4], default: 2
  -eos:   write End Of Stream marker
  -backendtpu: the device codec (the only backend)
  -bs{N}: block size (bytes) -> block-parallel LZTB container
  -ps{N}: shared preset-dictionary bytes for block-parallel mode (LZTB v2)
  -td{N}: train an N-byte dictionary from the input and store it in the
          container, priming every block (LZTB v3)
  -q:     quiet
"""

#: the training sample's size (lzma_tpu.parallel.filestream.DEFAULT_BATCH_BYTES)
TRAIN_SAMPLE_BYTES = 64 << 20


class CommandLine:
    """Switch parser with the reference's grammar (lzma_tpu.cli.CommandLine).
    A switch of the host codecs parses, as there, and is recorded in
    `unsupported` for the dispatch to refuse."""

    def __init__(self):
        self.command = None
        self.dict_size = 1 << 23
        self.lc, self.lp, self.pb = 3, 0, 2
        self.fb = 128
        self.eos = False
        self.block_size = 0
        self.preset_len = 0
        self.train_dict = 0
        self.quiet = False
        self.unsupported: list[str] = []
        self.in_file = None
        self.out_file = None

    def parse_switch(self, s: str) -> bool:
        try:
            if s.startswith("backend"):
                backend = s[7:]
                if backend not in ("scalar", "native", "tpu", "hybrid"):
                    return False
                if backend != "tpu":
                    self.unsupported.append(f"-backend{backend}")
            elif s.startswith("bs"):
                self.block_size = int(s[2:])
            elif s.startswith("d"):
                self.dict_size = 1 << int(s[1:])
            elif s.startswith("fb"):
                self.fb = int(s[2:])
            elif s.startswith("a"):
                int(s[1:])
                self.unsupported.append("-a")
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
                if s[2:] not in ("bt2", "bt4", "bt4b", "hc4", "fast4"):
                    return False
                self.unsupported.append("-mf")
            elif s == "tune":
                self.unsupported.append("-tune")
            elif s.startswith("td"):
                if s[2:] == "auto":
                    self.unsupported.append("-tdauto")
                else:
                    self.train_dict = int(s[2:])
                    if self.train_dict < 1:
                        return False
            elif s.startswith("t"):
                int(s[1:])
                self.unsupported.append("-t")
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
                          write_eos=self.eos)


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
    from .ops import api

    if cmd.command == "b":
        print("error: the benchmark (b) is not ported to the device codec")
        return 1
    if cmd.unsupported:
        print(f"error: {', '.join(cmd.unsupported)} not supported: the device "
              "codec is the only backend")
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
    if cmd.command == "e":
        params = cmd.params().validated_for_encode()
        if cmd.block_size:
            dictionary = b""
            if cmd.train_dict:
                from .utils.dicttrain import train_dictionary

                dictionary = train_dictionary(data[:TRAIN_SAMPLE_BYTES],
                                              cmd.train_dict)
            out = api.encode_blocks(data, params, block_size=cmd.block_size,
                                    preset_len=cmd.preset_len,
                                    dictionary=dictionary, device=device)
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
        print(f"{cmd.command}: {len(data)} -> {len(out)} bytes [device]")
    return 0
