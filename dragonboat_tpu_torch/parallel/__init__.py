"""Mesh execution: the mesh serving path (``ici``) and K1/K2
(``fabric_kernels``).

Exports what the reference's ``parallel/__init__.py`` exports.  They
load on first use: ``core/kernel.py`` imports ``fabric_kernels`` from
this package, and ``ici`` imports ``core/kernel.py``.
"""

_ICI_EXPORTS = ("IciCluster", "make_ici_cluster", "ici_cluster_step")


def __getattr__(name):
    if name in _ICI_EXPORTS:
        from dragonboat_tpu_torch.parallel import ici

        return getattr(ici, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
