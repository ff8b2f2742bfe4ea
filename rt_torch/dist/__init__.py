from rt_torch.dist.scaling import (ScalingResult, measure_multihost,
                                   measure_scaling)
from rt_torch.dist.sharding import (Mesh, gather_image, make_mesh,
                                    multihost_init, sample_sharded_render,
                                    shard_scene, shard_state,
                                    sharded_render_frame)
from rt_torch.dist.wave import (sharded_wave_frames, sharded_wave_render_frames,
                                sharded_wave_step)

__all__ = [
    "Mesh", "make_mesh", "shard_state", "shard_scene", "sharded_render_frame",
    "gather_image", "multihost_init", "sample_sharded_render",
    "sharded_wave_render_frames", "sharded_wave_step", "sharded_wave_frames",
    "ScalingResult", "measure_scaling", "measure_multihost",
]
