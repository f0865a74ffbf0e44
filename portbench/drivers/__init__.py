"""One driver per kind of traffic: ``train``, ``render``, ``serve`` (a mix's
``driver`` key names it); each has ``run(ctx)`` and ``control(ctx, variant)``."""
