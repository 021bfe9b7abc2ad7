"""The codec's stream error (the port's copy of
``lzma_tpu.core.rangecoder.CorruptStreamError``)."""


class CorruptStreamError(ValueError):
    """Raised when an LZMA stream or container is structurally invalid."""
