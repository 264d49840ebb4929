"""Command-line entry points, ported from ``hocon.cli``: ``train``
(supervised), ``trainwarp`` (photometric consistency), ``evaluate`` and
``predict``. Each ``main(argv=None, device=None)`` runs on CUDA unless the
caller passes ``device="cpu"``."""
