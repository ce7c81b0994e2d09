"""Solver configuration.

The same knobs, defaults and validation as the JAX package's
``SolverConfig`` (reference: src/options.jl:1-24), plus ``device``: the
torch device every tensor of a solve lives on. The entry points run on
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch


@dataclasses.dataclass
class SolverConfig:
    # -- tolerances (reference: src/options.jl:2-4,21-23) --------------------
    ptol: float = 1e-2            # primal infeasibility tolerance
    gtol: float = 0.0             # stationarity tolerance
    objtol: float = 1e-2          # duality-gap tolerance (inf to skip)
    ptol_mode: str = "relative"   # 'relative' (/ ||b||) or 'absolute'
    gtol_mode: str = "relative"   # 'relative' (/ ||C||_F) or 'absolute'
    objtol_mode: str = "relative"

    # -- augmented-Lagrangian schedule (src/options.jl:5-6) ------------------
    sigma0: float = 2.0           # initial penalty parameter
    sigmafac: float = 2.0         # penalty growth factor

    # -- iteration / time limits (src/options.jl:7,11-12) --------------------
    maxtime: float = 3600.0
    maxmajoriter: int = 10**5
    maxiter: int = 10**7

    # -- optimizer (src/options.jl:10,13-14) ----------------------------------
    numlbfgsvecs: int = 4
    fprec: float = 1e8            # stagnation break: rel ΔL < fprec * eps
    rankupd_tol: int = 4          # majoriters w/o gap progress before rank x2
    # rank doubling: 'warm' keeps the converged factor and appends small
    # random columns (plus λ/σ/tolerance state), so the solver only has
    # to learn the new directions; 'restart' re-draws R and resets all
    # schedule state like the reference (src/coreop.jl:518-526).
    rank_update_mode: str = "warm"

    # -- problem knowledge (src/options.jl:15) --------------------------------
    prior_trace_bound: float = 1e18

    # -- observability (src/options.jl:8-9,16-17) -----------------------------
    printlevel: int = 1
    printfreq: float = 60.0
    dataset: str = ""
    eval_DIMACS_errs: bool = False

    # -- eigensolver for the dual bound (src/options.jl:18) -------------------
    # False: randomized Lanczos (default). True: high-precision path
    # (Lanczos with full reorthogonalization + more iterations).
    eigval_highprecision: bool = False
    # Residual safeguard for the dual bound: subtract the Lanczos Ritz
    # residual β_k·|s_k| (plus ulp slack) from the λ_min estimate before
    # forming the dual value, so reported duality gaps are certified in
    # practice and termination can't fire on an unconverged eigensolve.
    # The reference uses the raw Ritz value (src/coreop.jl:503-511),
    # which can over-shoot λ_min and yield negative "gaps".
    dual_safeguard: bool = True

    # -- custom initialization (src/options.jl:19-20) -------------------------
    # init_func(problem, r, *init_args) -> (R0 [n, r], lam0 [m])
    init_func: Optional[Callable[..., Any]] = None
    init_args: Tuple = ()

    # -- device-specific -------------------------------------------------------
    # dtype of all device computation: "float32" or "float64"; None means
    # float32 (resolve_dtype has no process-wide side effect).
    dtype: Optional[str] = None
    seed: int = 0                 # PRNG seed for random R0 / Lanczos start
    inner_chunk: int = 1000       # device inner-loop steps per host sync
    # target seconds of device work per fused dispatch: the driver adapts
    # the per-dispatch step budget (≤ inner_chunk) to this wall time.
    # Long single dispatches (≥ ~30 s at n=100k) reproducibly fault the
    # remote TPU worker, and coarse dispatches also make maxtime checks
    # sluggish. 0 disables adaptation (always inner_chunk).
    dispatch_target_s: float = 5.0
    # fused outer driver (solver/major.py): the entire major-iteration state
    # machine — inner loop, dual bound, dual ascent, σ/tolerance schedule —
    # runs as ONE device program per dispatch, amortizing host<->device RTT
    # over many major iterations. False falls back to the host-driven loop.
    fused_outer: bool = True
    # dense MXU mode: hold C as a dense matrix so the hot ops are plain
    # matmuls (diagonal-constraint problems only). None = auto heuristic
    # (see compile.py), True = force, False = forbid.
    dense_mode: Optional[bool] = None
    # entrywise dense-mask mode: for equality-only problems whose narrow
    # constraints each touch one distinct triu position (e.g. Lovász-θ),
    # the inner loop carries violations/duals as dense masked matrices —
    # all constraint math becomes MXU matmuls + masked reductions
    # (ops/entrymask.py). None = auto (see compile.py), True = force
    # (error if ineligible), False = forbid.
    entry_mode: Optional[bool] = None
    # L-BFGS direction implementation: 'compact' (Byrd–Nocedal compact
    # representation — 3 MXU contractions/iter) or 'two_loop' (classic
    # recursion — 4k sequential dots/axpys). Identical math.
    lbfgs_impl: str = "compact"
    # inner-loop engine: 'auto' takes a CUDA megakernel
    # (ops/megakernel.py: K1 for equality problems, K2 for inequalities)
    # when the tensors are on CUDA and the problem is eligible (every
    # constraint entry diagonal, one per narrow constraint; K1 also needs
    # dense C), else the torch inner loop; 'mega' takes the kernel on
    # CUDA and its plain version on the CPU (error if ineligible); 'xla'
    # takes the torch inner loop (the name is kept from the JAX package).
    inner_impl: str = "auto"
    lanczos_tol_scale: float = 1.0
    # block-Lanczos dual bound (ops/blocklanczos.py): 0 = auto (block
    # path for n > 4096, or when the scalar schedule wants more than 1024
    # steps), -1 = always scalar, > 0 = force this block size.
    lanczos_block: int = 0
    # checkpoint at major boundaries (.npz, utils/checkpoint.py; the
    # host-driven loop honours checkpoint_every); profile_dir records the
    # solve with torch.profiler as a Chrome trace.
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 1     # major iterations between checkpoints
    profile_dir: Optional[str] = None
    # ranks to row-shard the solve over (parallel/): with a process group
    # initialized, its world size (every rank calls the solver); else this
    # many workers are started, one card each under NCCL on "cuda" (at
    # most the machine's cards) or gloo processes on "cpu"
    devices: int = 1
    # torch device of the solve: "cuda" (default; raises when no CUDA
    # device is present) or "cpu" (the tests' path, kernels' plain
    # versions)
    device: str = "cuda"

    def copy_with(self, **kwargs) -> "SolverConfig":
        unknown = set(kwargs) - {f.name for f in dataclasses.fields(self)}
        if unknown:
            raise ValueError(f"Unrecognized config keyword(s): {sorted(unknown)}")
        cfg = dataclasses.replace(self, **kwargs)
        if cfg.lbfgs_impl not in ("compact", "two_loop"):
            raise ValueError(
                f"lbfgs_impl must be 'compact' or 'two_loop', got "
                f"{cfg.lbfgs_impl!r}"
            )
        if cfg.rank_update_mode not in ("warm", "restart"):
            raise ValueError(
                f"rank_update_mode must be 'warm' or 'restart', got "
                f"{cfg.rank_update_mode!r}"
            )
        if cfg.inner_impl not in ("auto", "mega", "xla"):
            raise ValueError(
                f"inner_impl must be 'auto', 'mega' or 'xla', got "
                f"{cfg.inner_impl!r}"
            )
        return cfg


_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_dtype(config: SolverConfig) -> torch.dtype:
    """torch dtype of a solve: ``config.dtype`` or float32 when None."""
    if config.dtype is None:
        return torch.float32
    if isinstance(config.dtype, torch.dtype):
        return config.dtype
    name = str(config.dtype).replace("torch.", "")
    if name not in _DTYPES:
        raise ValueError(f"dtype must be 'float32' or 'float64', got {config.dtype!r}")
    return _DTYPES[name]


def require_device(device, what: str = "SolverConfig.device") -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent
    (no CPU fallback: the caller names the CPU itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} is 'cuda' but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def resolve_device(config: SolverConfig) -> torch.device:
    """torch device of a solve; raises when CUDA is asked for and absent."""
    return require_device(config.device)
