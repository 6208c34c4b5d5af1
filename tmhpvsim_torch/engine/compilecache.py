"""The executor's build report (own port of ``executor_doc`` of
tmhpvsim_tpu/engine/compilecache.py and of the JAX report's
``executor_section``).

The JAX package keeps its compiled XLA executables in a persistent
compilation cache; a run report's ``executor`` section counts the warm
(found) and cold (compiled) executables, the dispatches and the blocks a
dispatch carries.  The port's executables are the CUDA kernels' shared
libraries (kernels/build.py), built at first use into the build directory
(``--compile-cache DIR``, ``build.set_build_dir``).  ``build_all`` counts
each library nvcc built in this process (``executor.compile_cold_total``)
and each it found already built (``executor.compile_warm_total``); the
engine loops count their dispatch groups (``executor.dispatches_total``)
and set ``executor.blocks_per_dispatch``.  The counters go to the metrics
registry current when they are recorded, so a run under its own registry
(``obs.metrics.use_registry``) sees its own counts.

The JAX AOT warm-up (``fn.lower(...).compile()`` at build time) has no
counterpart: the libraries' build at first use is that step.  So the
section has no ``aot_warmup*`` keys.
"""

from __future__ import annotations

from typing import Optional

from tmhpvsim_torch.kernels import build
from tmhpvsim_torch.obs import metrics as obs_metrics


def executor_section(snap: dict) -> Optional[dict]:
    """The ``executor`` section of a registry snapshot; None when the run
    recorded no ``executor.*`` metric."""
    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})
    if not any(k.startswith("executor.")
               for k in list(counters) + list(gauges)):
        return None
    out = {
        "compile_warm": int(counters.get("executor.compile_warm_total", 0)),
        "compile_cold": int(counters.get("executor.compile_cold_total", 0)),
        "dispatches": int(counters.get("executor.dispatches_total", 0)),
    }
    if "executor.blocks_per_dispatch" in gauges:
        out["blocks_per_dispatch"] = \
            int(gauges["executor.blocks_per_dispatch"])
    return out


def executor_doc(registry=None) -> Optional[dict]:
    """The run report's ``executor`` section from ``registry`` (default:
    the current one), with ``cache_dir`` the kernels' build directory;
    None when nothing executor-related was recorded and no build directory
    was chosen (``--compile-cache``), so callers attach it
    unconditionally."""
    reg = registry if registry is not None else obs_metrics.get_registry()
    doc = executor_section(reg.snapshot())
    if doc is None and build.BUILD_DIR == build.DEFAULT_BUILD_DIR:
        return None
    doc = doc or {}
    doc.setdefault("compile_warm", 0)
    doc.setdefault("compile_cold", 0)
    doc["cache_dir"] = build.BUILD_DIR
    return doc
