"""Profiling (port of ``probav_tpu/utils/profiling.py``).

``trace``: a context manager around ``torch.profiler`` that writes a
Chrome trace (``trace.json``, loadable in Perfetto or
``chrome://tracing``) of the steps inside it into ``log_dir``.  The JAX
package writes an xplane for TensorBoard instead; a PyTorch profiler has
no xplane writer.  For work on a CUDA device it records the CUDA
activity only (the kernels, copies and memsets on the device and the
runtime calls that launched them): the CPU activity records every
operator on the host and slows a host-bound train loop enough to change
what the trace shows.  For work on the CPU it records the CPU activity.

The JAX module's ``StepTimer`` is not ported: nothing in either package
calls it.
"""

from __future__ import annotations

import contextlib
import os

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, device):
    """Profile the block, which runs on ``device``, into
    ``log_dir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    act = (ProfilerActivity.CUDA if torch.device(device).type == "cuda"
           else ProfilerActivity.CPU)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=[act])
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
