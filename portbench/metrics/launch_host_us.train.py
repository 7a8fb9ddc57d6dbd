"""Host microseconds a kernel launch call takes in the wrappers, over the
whole process (warm-up, traced stretch and window): the ``LAUNCH_HOST_NS``
of ``ops/fused_step.py``, ``fused_train.py`` and ``fused_cnca.py`` summed,
over the launches they time. ``fused_step`` and ``fused_cnca`` time every
launch they count; ``fused_train`` times its backward kernels (``*_bwd_*``)
only, since its forward launches are ``fused_step``'s and are timed there,
so each launch counts once. A launch's time is its ctypes call
(``fused_step.timed_launch``). None where a loaded wrapper module has no
such counter, or no launch was timed. Layer: the wrappers."""

import sys

MODULES = ("vsnca_tpu_torch.ops.fused_step", "vsnca_tpu_torch.ops.fused_train",
           "vsnca_tpu_torch.ops.fused_cnca")


def _timed(name, mod):
    if name.endswith(".fused_train"):
        return sum(n for k, n in mod.KERNEL_LAUNCHES.items() if "_bwd_" in k)
    return mod.LAUNCHES


def read(run):
    if run.kind != "train":
        return None
    mods = {m: sys.modules[m] for m in MODULES if m in sys.modules}
    if not mods or any(getattr(m, "LAUNCH_HOST_NS", None) is None for m in mods.values()):
        return None
    launches = sum(_timed(name, m) for name, m in mods.items())
    if not launches:
        return None
    return sum(m.LAUNCH_HOST_NS for m in mods.values()) / launches / 1e3
