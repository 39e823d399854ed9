"""What the port's card tests and ``chip_smoke.py`` share: the kernels each
path must launch, the edge-case point sets the kernels are held to
their plain versions on, and a way to reach K2's generic kernel."""
import numpy as np
import torch

#: kernels ``predict --bent --interp zp --quadrature hermite`` launches
SERVING_KERNELS = ("trace_leapfrog_zp", "zp_value_grad", "rows_value_fwd")
#: kernels ``map_gauss_newton`` on zp with Hermite quadrature launches
SOLVE_KERNELS = ("rows_value_fwd", "rows_value_bwd", "zp_value_grad",
                 "zp_value_grad_bwd")
#: kernels the tricubic model adds: ``trace_rays(method="leapfrog")`` on
#: cubic launches the first, ``map_gauss_newton`` on cubic with Hermite
#: quadrature the other two beside ``rows_value_fwd``/``rows_value_bwd``
CUBIC_KERNELS = ("trace_leapfrog_cubic", "cubic_value_grad",
                 "cubic_value_grad_bwd")
#: kernels ``map_gauss_newton`` on cubic with Hermite quadrature launches
CUBIC_SOLVE_KERNELS = ("rows_value_fwd", "rows_value_bwd", "cubic_value_grad",
                       "cubic_value_grad_bwd")
#: kernels ``kalman_filter`` on zp with Hermite quadrature launches (the
#: point filter: one state, so no member-axis kernel)
KALMAN_KERNELS = SOLVE_KERNELS
#: kernels ``ensemble_kalman_filter`` on zp with Hermite quadrature
#: launches: the member-axis gather and scatter with the pack of their
#: member axis and the scatter's fold, the member-axis endpoint value +
#: gradient (one launch for all members), and the endpoint transpose once
#: per member. The unbatched ``rows_value_fwd``/``rows_value_bwd`` run
#: only outside the member update (never once per member in its place),
#: and the unbatched ``zp_value_grad`` not at all.
MEMBER_KERNELS = ("rows_value_fwd_batched", "rows_value_bwd_batched",
                  "pack_members", "fold_member_rows", "zp_value_grad_batched")
ENKF_KERNELS = MEMBER_KERNELS + ("zp_value_grad_bwd",)
#: kernels the streaming service (``serving.EpochService``) launches at
#: ``EngineConfig``'s defaults (cubic, Hermite) with adaptive R: the
#: point filter's gather, scatter and endpoint kernels, the point order
#: each epoch's new geometry builds, and the member-axis gather (with its
#: pack) that pushes the adaptive-R probes through J as one batch
SERVICE_KERNELS = CUBIC_SOLVE_KERNELS + ("point_order_keys", "permute_points",
                                         "rows_value_fwd_batched",
                                         "pack_members")
#: ``predict``'s forms (``__main__.predict``) as the card tests and
#: ``chip_smoke.py`` run them at its defaults (cubic, Hermite@129, 1000
#: km, leapfrog@64): the keyword arguments of each and the kernels it must
#: launch. The dTEC gathers through K2 and its Hermite endpoints through
#: the model's value + gradient (K5 on cubic, K1e on zp); a bent bundle
#: is traced by the model's leapfrog tracer (K1c, which packs the table's
#: z taps, or K1); RM gathers n_e through K2 on cubic on every model.
PREDICT_FORMS = {
    "straight": ({}, ("rows_value_fwd", "cubic_value_grad")),
    "straight_rm": ({"rm": True}, ("rows_value_fwd", "cubic_value_grad")),
    "bent_rm": ({"bent": True, "rm": True},
                ("trace_leapfrog_cubic", "pack_z_taps", "rows_value_fwd",
                 "cubic_value_grad")),
    "bent_zp_rm": ({"bent": True, "interp": "zp", "rm": True},
                   ("trace_leapfrog_zp", "zp_value_grad", "rows_value_fwd")),
}


def edge_case_points(shape, origin, spacing, n, rng):
    """n points in index space mapped to world coordinates: uniform in and
    around the grid, exactly on lattice and half-lattice points, on the
    piece boundaries u+v = 0 and u−v = 0, and in the boundary cells."""
    nn = np.asarray(shape, np.float64)
    k = n // 8
    parts = [rng.uniform(-4.0, nn + 3.0, (n - 7 * k, 3)),
             rng.integers(0, nn, (k, 3)).astype(np.float64),
             rng.integers(0, nn - 1, (k, 3)) + 0.5]
    for sign in (1.0, -1.0):
        a = rng.choice([0.125, 0.25, 0.375, -0.25, 0.5], (k, 1))
        base = rng.integers(1, nn - 1, (k, 3)).astype(np.float64)
        parts.append(base + a * np.array([1.0, sign, 0.5]))
    parts.append(rng.uniform(-0.5, 1.5, (k, 3)))
    parts.append(nn - 1 - rng.uniform(-0.5, 1.5, (k, 3)))
    t = np.concatenate(parts, 0)
    return (np.asarray(origin) + t * np.asarray(spacing)).astype(np.float32)


def off_boundary(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` whose data starts 4 bytes past a 16-byte boundary.
    K2 given such inputs runs its generic kernel (one scalar load a value,
    in ray order), whatever its shape: the reference its fixed-shape
    kernel is held to bitwise."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out
