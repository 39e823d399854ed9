"""PyTorch/CUDA port of the ionospheric tomography engine.

The JAX package ``ionotomo_tpu`` is the reference; this package keeps its
layout (``core/``, ``models/``, ``geometry/``, ``forward/``,
``inversion/``, ``data/``, ``utils/``, ``plotting/``) and its function
names and signatures, with torch tensors in and out, so every counterpart
is found by path. Nothing here imports ``jax``. The commonly used names
are re-exported here, as the reference re-exports them, the multi-device
``parallel`` package (``grid_sharding``, ``sharding``) and
``member_parallel_enkf`` included; ``plotting`` is imported on its own
(matplotlib).

The hot primitives are hand-written CUDA kernels for Hopper
(``kernels/csrc``), built from the sources at first use. Each sits beside
its plain PyTorch version: a tensor on the CPU takes the plain version, a
tensor on a CUDA device launches the kernel or raises.

Float32 matmuls stay full f32, as the reference pins
``Precision.HIGHEST``: importing the package turns TF32 off for cuBLAS and
cuDNN, and every ``einsum`` site checks it (``core.precision``).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from .config import EngineConfig                              # noqa: E402,F401
from .core.grids import Grid3D                                # noqa: E402,F401
from .core import tricubic                                    # noqa: E402,F401
from .data.datapack import DataPack                           # noqa: E402,F401
from .data.radio_array import (RadioArray,                    # noqa: E402,F401
                               generate_lofar_like_array)
from .data.synth import generate_example_datapack             # noqa: E402,F401
from .data.ionosonde import (NeProbes, bottomside_probes,     # noqa: E402,F401
                             probes_from_arrays)
from .forward.tec import (tec, dtec, dtec_paired,             # noqa: E402,F401
                          tec_linear, tec_linear_adjoint,
                          ray_coverage)
from .forward.rm import rotation_measure, drm                 # noqa: E402,F401
from .forward.tec import vtec_map                             # noqa: E402,F401
from .utils.diagnostics import (phase_structure_function,     # noqa: E402,F401
                                structure_function,
                                fit_structure_exponent)
from .geometry.fermat import (trace_rays, trace_rays_split,   # noqa: E402,F401
                              trace_rays_stochastic)
from .geometry.rays import (RayBundle, calc_rays,             # noqa: E402,F401
                            sample_straight_rays, make_ray_batch,
                            inner_bundle)
from .inversion.kalman import (kalman_filter,                 # noqa: E402,F401
                               ensemble_kalman_filter,
                               initial_ensemble,
                               member_parallel_enkf)
from .inversion.online import (OnlineKalman,                  # noqa: E402,F401
                               OnlineEnsembleKalman)
from .inversion.empirical_bayes import (log_marginal_family,  # noqa: E402,F401
                                        fit_hyperparameters)
from .inversion.model_selection import (gcv_score,            # noqa: E402,F401
                                        select_prior)
from .inversion.pipeline import InversionPipeline             # noqa: E402,F401
from .inversion.priors import (GPCovariance,                  # noqa: E402,F401
                               fit_shell_spectrum, laplacian)
from .inversion.anchors import (TecAnchors,                   # noqa: E402,F401
                                vertical_anchor_bundle,
                                anchors_from_field,
                                assimilate_probes,
                                probe_sqrt_update)
from .inversion.profile import (ProfileParams,                # noqa: E402,F401
                                map_gauss_newton_profile,
                                chapman_log_field, log_profile_rms)
from .inversion.solution import Solution                      # noqa: E402,F401
from .inversion import solvers                                # noqa: E402,F401
from .inversion.solvers import map_gauss_newton_robust        # noqa: E402,F401
from .models.chapman import (chapman_field, chapman_ne,       # noqa: E402,F401
                             background_ne_fn,
                             altitude_field, multi_chapman_field,
                             log_parametrize, ne_from_log,
                             grid_enclosing_rays)
from .models.frozen_flow import (advect_periodic,             # noqa: E402,F401
                                 estimate_wind,
                                 frozen_flow_sequence)
from .models.turbulence import (turbulent_log_perturbation,   # noqa: E402,F401
                                turbulent_realizations)
from .parallel import grid_sharding, sharding                 # noqa: E402,F401
