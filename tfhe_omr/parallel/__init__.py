"""Device-mesh scaling of detection and digest reduction."""

from tfhe_omr.parallel.mesh import ShardedDetector, make_data_mesh

__all__ = ["ShardedDetector", "make_data_mesh"]
