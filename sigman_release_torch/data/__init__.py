"""Host-side data: the HGS-1M reader, the synthetic avatar dataset,
augmentation, batching."""

from sigman_release_torch.data.dataset import (  # noqa: F401
    HGSDataset,
    SyntheticAvatarDataset,
)
from sigman_release_torch.data.loader import (  # noqa: F401
    DataLoader,
    shard_for_host,
)
