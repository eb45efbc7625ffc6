"""PyTorch/CUDA port of the batched Raft step, the on-device router and the
device KV state machine.

The JAX package ``dragonboat_tpu`` is the reference this package is held
against, leaf for leaf and bit for bit (``tests/test_torch_*.py``).  This
package imports neither ``jax`` nor anything of ``dragonboat_tpu``: it
keeps its own copies of what it needs.

Layout mirrors the reference so each module's counterpart is easy to find:
``core/`` (params, state layout, step kernel, router), ``parallel/`` (the
fabric kernels K1 and K2), ``rsm/`` (``DeviceKV`` and its apply kernel K3),
``bench_loop.py`` (the self-driving replicated-KV loop) and ``convert.py``
(carrying state to and from the reference's numpy form).  The hand-written
CUDA kernels live in ``csrc/`` and are built at first use by ``kernels/``.

Entry points take an explicit ``device``.  Without one they run on the
CUDA card and raise when there is none; they never fall back to the CPU.
"""

from dragonboat_tpu_torch.devices import resolve_device

__all__ = ["resolve_device"]
