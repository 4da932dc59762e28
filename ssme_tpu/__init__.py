"""ssme_tpu: a JAX state-space model estimation framework for GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
reference C++ library ``tbrown122387/ssme``:

- parameter transform machinery (``ssme_tpu.transforms``; reference
  ``include/ssme/parameters.h``)
- random-variate sampling + density evaluation (``ssme_tpu.rv``; reference
  ``pf/rv_samp.h`` / ``pf/rv_eval.h`` surface)
- on-device resampling (``ssme_tpu.resampling``; reference
  ``pf/resamplers.h`` and ``include/ssme/liu_west_filter.h:25-145``)
- particle filters: bootstrap, auxiliary, Liu-West families
  (``ssme_tpu.filters``; reference ``pf/bootstrap_filter*.h``,
  ``include/ssme/liu_west_filter.h``)
- adaptive PMMH and particle-swarm inference (``ssme_tpu.inference``;
  reference ``include/ssme/ada_pmmh_mvn.h``, ``include/ssme/pswarm_filter.h``)
- device-mesh parallelism replacing the reference thread pools
  (``ssme_tpu.parallel``; reference ``include/ssme/thread_pool.h``)
- IO: CSV data/params, sample + message streams, checkpoints
  (``ssme_tpu.io``; reference ``include/ssme/utils.h``,
  ``include/ssme/ada_pmmh_mvn.h:272-322``)

Everything in the compute path is pure-functional JAX: models are pytrees
of pure functions, particles/replicates/chains are ``vmap``/``shard_map``
axes, and time is a ``lax.scan``.
"""

from ssme_tpu import transforms
from ssme_tpu import rv
from ssme_tpu import resampling
from ssme_tpu import utils
from ssme_tpu import models
from ssme_tpu import filters
from ssme_tpu import inference
from ssme_tpu import parallel
from ssme_tpu import io
from ssme_tpu import native
from ssme_tpu import diagnostics

__version__ = "0.1.0"

__all__ = [
    "transforms",
    "rv",
    "resampling",
    "utils",
    "models",
    "filters",
    "inference",
    "parallel",
    "io",
    "native",
    "diagnostics",
    "__version__",
]
