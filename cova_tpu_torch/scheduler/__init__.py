from cova_tpu_torch.scheduler.tracks import HostTracker  # noqa: F401
from cova_tpu_torch.scheduler.selector import FrameSelector, SelectorCounts  # noqa: F401
