"""Trace the RuntimeWarning scipy's BFGS raised inside the depth ensemble on the card.

    python3 perf/torch_ensemble_warning.py [--npz chiprun_out/bfgs_warned_members.npz]

First, on any host (the card's included), a probe of the mechanism: scipy's
version, and its BFGS from a float32 start as `align_depths` (and the JAX
package's `ensemble_depths`) begin it, with the default absolute
finite-difference step (sqrt of float64's eps, 1.49e-8), which a float32
coordinate of magnitude >= 0.25 cannot represent: the warnings it raises and
where. Then, where JAX imports and the `.npz` exists: `chip_smoke.py` runs `ops.ensemble.align_depths` (phases 14 and 15) under
`warnings.catch_warnings` and writes the members of the first call that
warned in each phase to the `.npz`, with its arguments, the (scale, shift)
the card's run found and where the warning came from. This script runs on
the CPU, with the JAX package and the port side by side (the one place
besides the tests that imports both): for each recorded call, the same
float32 members go through the JAX package's `ensemble_depths` and the
port's, each under `warnings.catch_warnings(record=True)`. It prints each
warning with its file, line and source line, each side's (scale, shift),
and the port's depth and uncertainty against the JAX package's, bounded by
the BFGS drift that `tests/_torch_port.py::ENSEMBLE_DRIFT` states. The
verdict line says whether the port diverges from the reference on these
members (a warning the JAX side does not raise, or a result beyond the
drift).
"""

from __future__ import annotations

import argparse
import json
import linecache
import os
import sys
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENSEMBLE_DRIFT = 0.1  # tests/_torch_port.py: BFGS over two float32 objectives walks to other (s, t)


def traced(fn, *args, **kw):
    """(result, [(file, line, source line, message)] of the RuntimeWarnings fn raised)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result = fn(*args, **kw)
    return result, [(w.filename, w.lineno, linecache.getline(w.filename, w.lineno).strip(), str(w.message))
                    for w in caught if issubclass(w.category, RuntimeWarning)]


def probe() -> None:
    """scipy's BFGS on a float32 quadratic from a float32 x0 of scales and
    shifts as `align_depths` starts them (a member already spanning [0, 1]:
    s = 1, t = -0)."""
    import scipy
    from scipy.optimize import minimize

    x0 = np.array([1.0, 0.5, 0.2, -0.0], np.float32)
    step = float(np.sqrt(np.finfo(np.float64).eps))
    lost = [float(v) for v in x0 if np.float32(v) + np.float32(step) == np.float32(v)]
    res, found = traced(minimize, lambda x: np.float32(np.sum((np.asarray(x, np.float32) - 0.3) ** 2)), x0,
                        method="BFGS", tol=1e-3, options={"maxiter": 2, "disp": False})
    print(f"probe: scipy {scipy.__version__}; x0 float32 {x0.tolist()}; absolute step {step:.4g} vanishes in "
          f"float32 at {lost}; BFGS x -> {np.round(res.x, 6).tolist()} (optimum 0.3), {res.nit} iterations")
    for filename, lineno, source, message in found:
        print(f"probe: RuntimeWarning at {filename}:{lineno}: {message}  |  {source}")
    if not found:
        print("probe: no RuntimeWarning")


def objective64(members: np.ndarray, st: np.ndarray, reduction: str = "median", strength: float = 0.02) -> float:
    """`_depth_objective` in float64 (numpy), to weigh two (s, t) without float32 rounding."""
    n = members.shape[0]
    aligned = members.astype(np.float64) * st[:n, None, None] + st[n:, None, None]
    ii, jj = np.triu_indices(n, k=1)
    pairwise = np.sqrt(np.mean([np.mean((aligned[i] - aligned[j]) ** 2) for i, j in zip(ii, jj)]))
    pred = aligned.mean(axis=0) if reduction == "mean" else np.sort(aligned, axis=0)[(n - 1) // 2]
    return float(pairwise + (abs(pred.min()) + abs(1.0 - pred.max())) * strength)


def jax_bfgs(jens, members: np.ndarray, start: np.ndarray, options: dict):
    """The JAX package's BFGS call (`ensemble_depths`' own), returning scipy's result."""
    import jax.numpy as jnp
    from scipy.optimize import minimize

    n, images = members.shape[0], jnp.asarray(members)
    kw = {k: options[k] for k in ("reduction", "regularizer_strength") if k in options}

    def closure(x):
        return np.float32(jens._depth_objective(images, jnp.asarray(x[:n], jnp.float32),
                                                jnp.asarray(x[n:], jnp.float32), **kw))

    return minimize(closure, start, method="BFGS", tol=options.get("tol", 1e-3),
                    options={"maxiter": options.get("max_iter", 2), "disp": False})


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--npz", default=os.path.join(REPO, "chiprun_out", "bfgs_warned_members.npz"))
    args = p.parse_args()
    probe()
    if not os.path.exists(args.npz):
        print(f"no {args.npz}: nothing to compare")
        return 0
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    try:
        import jax
    except ImportError:
        print("JAX does not import here: run the comparison on a host with the JAX package")
        return 0

    jax.config.update("jax_platforms", "cpu")
    import torch

    from diffusion_e2e_ft_tpu.ops import ensemble as jens
    from diffusion_e2e_ft_tpu_torch.ops import ensemble as tens

    saved = np.load(args.npz)
    labels = sorted({key.split("/")[0] for key in saved.files})
    diverges = []
    for label in labels:
        members = saved[f"{label}/members"]
        call_args, kw = json.loads(str(saved[f"{label}/args"]))
        print(f"== {label}: members {list(members.shape)} {members.dtype}, align_depths args {call_args} {kw}; "
              f"on the card: {json.loads(str(saved[f'{label}/where']))}")
        print(f"   the card's (s, t): {np.round(saved[f'{label}/scale'], 6).tolist()} "
              f"{np.round(saved[f'{label}/shift'], 6).tolist()}")
        names = ("regularizer_strength", "max_iter", "tol", "reduction", "max_res")
        options = {**dict(zip(names, call_args)), **kw}
        (st, t_warn) = traced(tens.align_depths, torch.from_numpy(members), **options)
        (want, j_warn) = traced(jens.ensemble_depths, members, **options)
        got = tens.combine_depths(torch.from_numpy(members), *st, options.get("reduction", "median"))
        for side, found in (("port (CPU)", t_warn), ("JAX (CPU)", j_warn)):
            for filename, lineno, source, message in found:
                print(f"   {side}: RuntimeWarning at {filename}:{lineno}: {message}  |  {source}")
            if not found:
                print(f"   {side}: no RuntimeWarning")
        flat = members.reshape(members.shape[0], -1)
        s_init = 1.0 / np.maximum(flat.max(axis=1) - flat.min(axis=1), 1e-8)  # align_depths' start
        start = np.concatenate([s_init, -s_init * flat.min(axis=1)]).astype(np.float32)
        print(f"   port (CPU) (s, t): {np.round(st[0], 6).tolist()} {np.round(st[1], 6).tolist()}; this host's and "
              f"the card's (s, t) equal the BFGS start (min-max): "
              f"{np.array_equal(np.concatenate(st), start)}, "
              f"{np.array_equal(np.concatenate([saved[f'{label}/scale'], saved[f'{label}/shift']]), start)}")
        if options.get("max_res") is None:
            res = jax_bfgs(jens, members, start, options)
            reduction, strength = options.get("reduction", "median"), options.get("regularizer_strength", 0.02)
            print(f"   JAX (CPU) BFGS: {res.nit} iterations, (s, t) {np.round(res.x, 6).tolist()}; float64 "
                  f"objective at the start {objective64(members, start.astype(np.float64), reduction, strength):.9f}, "
                  f"at the port's {objective64(members, np.concatenate(st), reduction, strength):.9f}, at the JAX "
                  f"package's {objective64(members, res.x.astype(np.float64), reduction, strength):.9f}")
        drift = max(float(np.abs(got[0].numpy() - want[0]).max()), float(np.abs(got[1].numpy() - want[1]).max()))
        finite = bool(np.isfinite(got[0].numpy()).all() and np.isfinite(want[0]).all())
        print(f"   port vs JAX: depth and uncertainty max|d| {drift:.3e} (drift bound {ENSEMBLE_DRIFT}); "
              f"both finite {finite}")
        if (t_warn and not j_warn) or drift > ENSEMBLE_DRIFT or not finite:
            diverges.append(label)
    print(f"verdict: the port {'DIVERGES on ' + str(diverges) if diverges else 'matches the JAX package'} "
          f"on the members that warned on the card")
    return 1 if diverges else 0


if __name__ == "__main__":
    sys.exit(main())
