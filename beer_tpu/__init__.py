"""beer_tpu — a Bayesian speech-modeling framework in JAX.

A ground-up JAX/XLA/Pallas redesign with the capabilities of the reference
``beer-asr/beer`` toolkit (variational-Bayes conjugate exponential-family
models for speech: GMM, HMM, phone-loop AUD, PPCA, PLDA, VAE, subspace
models).  See SURVEY.md for the reference analysis this build follows.

Design stance (idiomatic JAX, not a port):

* every conjugate prior is a flat **natural-parameter vector**; each family
  implements only ``log_norm`` and gets expected sufficient statistics as
  ``grad(log_norm)`` and KL divergences as Bregman divergences — exact, and
  XLA fuses everything,
* a model is a **pytree of BayesianParameters**; the VB M-step is plain
  vector addition in natural coordinates (no autograd hooks),
* HMM forward-backward / Viterbi are **batched scans** in the log semiring
  (sequential `lax.scan` with an exp-shift matmul step — one Pallas kernel
  per pass on a GPU — plus a `lax.associative_scan` variant for long
  sequences),
* data parallelism is ``shard_map`` over a device mesh with one ``psum`` of
  the sufficient-statistics pytree per step (the on-chip equivalent of the
  reference's file-based SGE map-reduce).

Public API mirrors the reference (``Model.sufficient_statistics``,
``expected_log_likelihood``, ``Mixture.create``, ``evidence_lower_bound``,
``VBConjugateOptimizer``) so reference notebooks port with a backend switch.
"""

from beer_tpu import dists

__version__ = "0.1.0"

from beer_tpu.models import *  # noqa: F401,F403,E402
from beer_tpu.vbi import (  # noqa: F401,E402
    VBConjugateOptimizer,
    VBOptimizer,
    elbo_and_stats,
    evidence_lower_bound,
    vb_step,
)
