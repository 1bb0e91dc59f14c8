"""Host-side data: the synthetic avatar dataset, augmentation, batching."""
