"""BAL text I/O -> PCG solve -> mid-BA checkpoint -> exact resume.

Reference analog: ``bundle_io.py`` load/save (SURVEY §2). The solver is
the BAL-scale component-major path (matrix-free PCG with Eisenstat-Walker
adaptive forcing); the checkpoint carries the full LM state (λ, ν, CG
warm-start vector) so the resumed run continues the identical trajectory.
See bench/venice.py for the full BAL/Venice-scale harness.

Run:  python3 examples/bal_checkpoint_resume.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import dataclasses
import os
import tempfile

import numpy as np

from pysfm_tpu.io import bal, checkpoint
from pysfm_tpu.problem import cm
from pysfm_tpu.solver import LMConfig, solve

tmp = tempfile.mkdtemp()
path = os.path.join(tmp, "problem.txt")

# Synthetic stand-in for a BAL dataset (offline container), written and
# re-read through the real text format (native C++ tokenizer when built,
# NumPy fallback otherwise).
_, perturbed = bal.make_synthetic_bal(
    30, 2000, noise_px=0.5, visibility=0.4, seed=7, dtype=np.float32
)
bal.save_bal(path, perturbed)
prob = bal.load_bal(path, dtype=np.float32)
print(f"loaded {prob.n_cameras} cams / {prob.n_points} pts / "
      f"{prob.n_obs} obs from {path}")

cfg = LMConfig(
    max_iters=8, solver="pcg", cg_iters=25, cg_tol=1e-2,
    cg_forcing="ew", cg_q_tol=0.3,
    tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0,
)
cmp = cm.from_problem(prob)
half, st = solve(cmp, cfg)
ck = os.path.join(tmp, "ba_state")
checkpoint.save_checkpoint_cm(
    ck, half, lam=float(st.lam_next), nu=float(st.nu_next),
    iteration=int(st.n_iters),
)

# Resume: a fresh process would do exactly this.
loaded, lam, nu, it = checkpoint.load_checkpoint_cm(ck)
resumed, st2 = solve(
    loaded, cfg, lam_init=lam, nu_init=nu, dc_init=np.asarray(st.dc_next)
)

# Reference: 16 uninterrupted iterations on the same problem.
full, st_full = solve(
    cm.from_problem(prob), dataclasses.replace(cfg, max_iters=16)
)
c_resumed, c_full = float(st2.costs[-1]), float(st_full.costs[-1])
print(f"cost {float(st.costs[0]):.1f} -> {c_resumed:.4f} resumed across a "
      f"checkpoint vs {c_full:.4f} uninterrupted")
assert abs(c_resumed - c_full) <= 1e-4 * abs(c_full)
print("OK")
