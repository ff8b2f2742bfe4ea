from rt_torch.utils.profiling import (RenderStats, Timer, device_sync,
                                      profile_trace)

__all__ = ["RenderStats", "Timer", "device_sync", "profile_trace"]
