"""Host-side helpers of the port (own copies of lzma_tpu.utils parts)."""
