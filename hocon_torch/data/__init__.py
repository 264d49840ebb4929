"""Data: the synthetic dataset, the FPHAB and HO-3D parsers, ``HandDataset``
(crop / augment / labels), frames read without cv2 (``images``),
``check_dataset``, ``get_dataset`` and ``BatchLoader``, ported from
``hocon.data``."""
