"""voxelhashing_tpu: a dense RGB-D SLAM engine in JAX.

JAX/XLA implementation of the full VoxelHashing pipeline (Nießner et al.
2013; reference surveyed in SURVEY.md, component mapping in PARITY.md):
sparse TSDF voxel map, per-frame depth integration, surface prediction,
multi-resolution projective-ICP tracking, garbage collection,
marching-tetrahedra meshing, device<->host streaming with a C++ chunk
store, keyframe pose-graph loop closure, and multi-device map sharding —
one jit-compiled device program per frame (deterministic
prefix-sum/scatter-claim structures, splat-based rendering, collectives
over a device mesh).
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .config import (CameraConfig, EngineConfig, MapConfig,  # noqa: F401
                     RaycastConfig, StreamingConfig, TrackerConfig)

# Core modules are imported lazily by consumers to keep `import
# voxelhashing_tpu` light; the canonical entry points are:
#   engine.make_step / engine.create        per-frame reconstruction
#   blockmap / integrate / raycast / tracking   pipeline stages
#   meshing.extract_mesh / extract_mesh_streamed / save_ply
#   streaming.StreamingManager / AsyncStreamingManager / save_map / load_map
#     (whole-map meshing + checkpoints compose device + host tiers when a
#      manager is passed; stream_in_all inverts stream_out_all)
#   posegraph.PoseGraph                     loop closure + optimization
#   parallel.sharded.make_sharded_step      multi-device map sharding
#   evaluation.ate_rmse / rpe_rmse          trajectory metrics
#   densegrid.create / integrate / render   dense voxel-grid baseline (§2.9)
