"""Alpha compositing for volume rendering.

Port of the JAX package's `ops/compositing.py`. `composite_weights` is the
reference's deltas -> alphas -> transmittance -> weights tail, with the
NeRF++ `bg_lambda` (transmittance past the last sample).

The coarse+fine merge: the JAX eval path on non-TPU backends uses
`composite_weights_merge`, a sort-free two-sorted-lists form built for the
TPU, where sorts are scalar loops. Its result equals concatenating the two
sample lists, sorting them stably in composite order and compositing the
sorted list, which is how `composite_weights_merge` computes it here: on
the GPU a sort is cheap.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CompositeWeights(NamedTuple):
    weights: torch.Tensor  # (N, S) per-sample compositing weights
    bg_lambda: torch.Tensor  # (N,) transmittance after the final sample


def composite_weights(
    sigmas: torch.Tensor,
    z_vals: torch.Tensor,
    last_delta: torch.Tensor,
    flip: bool = False,
) -> CompositeWeights:
    """Per-sample compositing weights from densities and depths.

    sigmas, z_vals: (N, S), z ascending (descending when `flip`, the
    background's order); last_delta: (N,) or (N, 1), the segment past the
    final sample.

    weights[i] = alpha[i] * prod_{j<i}(1 - alpha[j] + 1e-8)
    bg_lambda = prod_j (1 - alpha[j] + 1e-8)
    """
    if last_delta.dim() == sigmas.dim():
        last_delta = last_delta[..., 0]
    if flip:
        deltas = z_vals[..., :-1] - z_vals[..., 1:]
    else:
        deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, last_delta[..., None]], dim=-1)

    alphas = 1.0 - torch.exp(-deltas * sigmas)
    trans = torch.cumprod(1.0 - alphas + 1e-8, dim=-1)
    bg_lambda = trans[..., -1]
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return CompositeWeights(weights=alphas * trans, bg_lambda=bg_lambda)


def composite_weights_merge(
    z_a: torch.Tensor,
    sigmas_a: torch.Tensor,
    z_b: torch.Tensor,
    sigmas_b: torch.Tensor,
    last_delta: torch.Tensor,
    flip: bool = False,
) -> CompositeWeights:
    """Compositing weights for the union of two sample lists.

    The same contract as the JAX package's `composite_weights_merge`:
    z_a/sigmas_a (N, Sa), z_b/sigmas_b (N, Sb); weights come back in concat
    order [A | B]. The union is sorted stably in composite order (ascending
    z, descending when `flip`), so a B sample tied with an A sample
    composites after it, then composited with `composite_weights`; the
    weights are scattered back to concat order. Every consumer (rgb and
    depth sums) is order-invariant, so payloads are never reordered."""
    z = torch.cat([z_a, z_b], dim=-1)
    sigmas = torch.cat([sigmas_a, sigmas_b], dim=-1)
    order = torch.sort(-z if flip else z, dim=-1, stable=True).indices
    cw = composite_weights(
        torch.gather(sigmas, 1, order), torch.gather(z, 1, order),
        last_delta, flip=flip,
    )
    weights = torch.empty_like(cw.weights).scatter_(1, order, cw.weights)
    return CompositeWeights(weights=weights, bg_lambda=cw.bg_lambda)
