"""pysfm_tpu — an accelerator-native structure-from-motion framework in JAX.

A from-scratch, array-first re-design of the capability surface of
``alexflint/pysfm`` (see SURVEY.md; the reference mount was empty at build
time, so capability citations point at SURVEY.md sections anchored on
BASELINE.json rather than reference file:line):

- L0 ``geometry``   — SO(3)/SE(3), projection (SURVEY §1 L0)
- L1 ``problem``    — SoA bundle problem, robust costs, analytic Jacobians
  (SURVEY §1 L1, §2 "Bundle / measurement model", "Robust sensor models")
- L2 ``solver``     — on-device Levenberg–Marquardt with Schur complement
  (SURVEY §1 L2, §3.1)
- L3 ``frontend``   — features, matching, epipolar geometry, RANSAC,
  triangulation, PnP (SURVEY §1 L3)
- L4 ``pipeline``   — incremental SfM driver (SURVEY §1 L4)
- L5 ``io``         — BAL/Bundler IO, checkpointing, viz (SURVEY §1 L5)
- L7 ``dist``       — mesh/sharding, distributed Schur reduction (SURVEY §1 L7)

Everything in the compute path is jax (XLA/Pallas); the problem state is
structure-of-arrays with static shapes, and the LM loop runs entirely on
device inside ``lax.while_loop`` with no per-iteration host round-trips.
"""

__version__ = "0.1.0"

from pysfm_tpu import geometry, problem, solver  # noqa: F401
