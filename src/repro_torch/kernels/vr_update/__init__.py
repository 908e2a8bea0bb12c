"""K1: the fused CentralVR/SAGA update, on two routes: per step
(``kernel.py`` wrapper and build, ``csrc/vr_update.cu``; the LM steps) and
per epoch (``epoch.py``, ``csrc/vr_epoch.cu``; the convex paths, a whole
fused epoch of p workers in one launch). ``ref.py`` holds both plain
versions."""
