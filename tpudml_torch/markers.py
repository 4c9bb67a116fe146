"""Named regions of the port's programs, for the graph pass.

JAX jits a program under a name (``_serve_decode_step``,
``_fused_xent_unsharded``, ...) and its analyzers find that name in the
traced jaxpr. The port runs eagerly, so the same names mark regions of a
step instead: the ``@marked(NAME)`` decorator around the code JAX jits
under NAME, and ``@kernel_op`` around
each wrapper of ``tpudml_torch/ops/`` that launches a hand-written kernel
on the card (and runs its plain version on the CPU). The marker strings
themselves stand beside the port's counterparts of the JAX modules that
define them (``serve/engine.py``'s ``SERVE_DECODE_MARKER``, ...).

While no capture runs (``tpudml_torch.analysis.capture``), a marked call
costs one extra Python frame and one global read: nothing is recorded and
no profiler is on.
This module imports nothing of the package, so that the engines can mark
their code without importing ``tpudml_torch.analysis`` (which imports the
engines, through its entrypoint registry).
"""

from __future__ import annotations

import functools

#: The capture recording the current step, or None. Set only by
#: ``tpudml_torch.analysis.capture`` (one capture at a time, read from every
#: thread: autograd runs a CUDA backward on a thread of its own).
_capture = None

#: Prefix of the region a kernel wrapper opens (``kernel_op``).
KERNEL_PREFIX = "kernel:"


def marked(name: str):
    """Decorator: every call of the function is region ``name``, its
    positional and keyword arguments the region's operands."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            cap = _capture
            if cap is None:
                return fn(*args, **kwargs)
            with cap.region(name, (args, kwargs)) as r:
                out = fn(*args, **kwargs)
                r.outputs(out)
                return out

        return call

    return wrap


def kernel_op(fn):
    """Decorator of a kernel wrapper: region ``kernel:<its name>``. The
    graph pass reads such a region as one opaque node, the same on the
    card (a launch) as on the CPU (the plain version's ops)."""
    return marked(KERNEL_PREFIX + fn.__name__)(fn)


def on_launch(kernel) -> None:
    """Called by ``ops.cuda_lib.Kernel.launch`` after each launch."""
    cap = _capture
    if cap is not None:
        cap.on_launch(kernel.name)
