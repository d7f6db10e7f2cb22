"""Multi-device execution: block data-parallelism and the ctx-sharded
frozen decode and index-sharded aligner (parallel/mesh.py)."""
