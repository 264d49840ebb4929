"""Data: the synthetic dataset, ``HandDataset`` (crop / augment / labels),
``get_dataset`` and ``BatchLoader``, ported from ``hocon.data``."""
