"""fastqueeze_tpu_torch — the fastqueeze FASTQ compressor on PyTorch + CUDA.

Port of fastqueeze_tpu (the JAX package, kept as the reference): the same
archive format, byte for byte.  The frozen-table wave-rANS coder of the
single-end compress/decompress path runs as hand-written CUDA kernels
(ops/kernels.py, csrc/); host stages are the reference's, copied.
"""

__version__ = "0.1.0"

from fastqueeze_tpu_torch.config import CodecParams  # noqa: F401
