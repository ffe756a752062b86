"""Plain PyTorch ops: camera, SDF scenes, march, shading, compaction."""
