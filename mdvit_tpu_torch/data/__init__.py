"""The data path: datasets and splits, the stores on the card, the
round-robin sampler, on-device augmentation and serving preprocessing."""
