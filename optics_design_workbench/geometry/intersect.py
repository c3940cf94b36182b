'''
Nearest-intersection search over the compiled surface table.

Device-side equivalent of the reference's `Ray.findNearestIntersection`
(reference: freecad_elements/ray.py:290-401): every surface instance is
tested in parallel (the brute-force analog of OCC's per-face loop; there
is no broad phase yet), rays are transformed into each surface's local frame, and the winner
is selected with the reference's tie-breaking semantics: among all hits
within 2*distTol of the closest one, prefer the closest hit that does NOT
belong to the medium the ray currently travels in (ray.py:388-401).
'''

import jax
import jax.numpy as jnp
from jax import lax

from . import surfaces as S

# full f32 for the oracle's rotations: a GPU may otherwise run an f32
# matrix-vector product in TF32 (about 3 decimal digits)
_HIGHEST = lax.Precision.HIGHEST


def _matvec(rot, v):
  return jnp.matmul(rot, v, precision=_HIGHEST)


def _toLocal(rot, off, o, d):
  return _matvec(rot, o) + off, _matvec(rot, d)


def allDistances(table, o, d, tMin, seqAllowed=None):
  '''Distances from one world ray to every surface; +inf where no valid hit.
  Dispatches one vectorized kernel per surface *kind* over that kind's
  contiguous slice of the (kind-sorted) table — no per-surface switch, so
  scenes only pay for the surface kinds they contain. `seqAllowed`
  (bool (S,)) optionally masks surfaces not allowed at the current
  sequential-mode index (reference: find.py:79-104).'''
  parts = []
  # IMPORTANT: iterate in kind-code order, matching the kind-sorted flat
  # table — jit pytree round-trips rebuild dicts with alphabetically sorted
  # keys, so insertion order must never be relied on here
  for kindName in sorted(table['byKind'], key=S.KIND_CODES.get):
    sub = table['byKind'][kindName]
    fn = S.KIND_INTERSECTORS[kindName]

    haveMask = 'trimMaskIdx' in sub
    havePrims = 'trimPrims' in sub
    masks = table['trimMasks'] if haveMask else None

    def one(params, trim, w2lRot, w2lOff, mIdx=None, prims=None, fn=fn):
      lo, ld = _toLocal(w2lRot, w2lOff, o, d)
      return fn(params, trim, lo, ld, tMin,
                mask=(masks[mIdx] if mIdx is not None else None),
                prims=prims)

    args = [sub['params'], sub['trim'], sub['w2lRot'], sub['w2lOff']]
    if haveMask and havePrims:
      parts.append(jax.vmap(lambda p, t, r, of, mi, pr: one(
          p, t, r, of, mi, pr))(*args, sub['trimMaskIdx'],
                                sub['trimPrims']))
    elif haveMask:
      parts.append(jax.vmap(lambda p, t, r, of, mi: one(p, t, r, of, mi))(
          *args, sub['trimMaskIdx']))
    elif havePrims:
      parts.append(jax.vmap(lambda p, t, r, of, pr: one(
          p, t, r, of, prims=pr))(*args, sub['trimPrims']))
    else:
      parts.append(jax.vmap(lambda p, t, r, of: one(p, t, r, of))(*args))
  t = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
  if seqAllowed is not None:
    t = jnp.where(seqAllowed, t, jnp.inf)
  return t


def selectNearest(t, elem, medium, distTol, maxRayLength):
  '''Reference tie-breaking (ray.py:388-401): clip to maxRayLength; among
  candidates within [tMin, tMin + 2*distTol], prefer the closest whose
  element differs from the current medium; otherwise the closest overall.
  Returns (hitIndex, tHit, hasHit).'''
  t = jnp.where(t <= maxRayLength, t, jnp.inf)
  tMinAll = jnp.min(t)
  valid = jnp.isfinite(t)
  prefer = valid & (t <= tMinAll + 2 * distTol) & (elem != medium)
  hasPrefer = jnp.any(prefer)
  tPref = jnp.where(prefer, t, jnp.inf)
  idx = jnp.where(hasPrefer, jnp.argmin(tPref), jnp.argmin(t))
  hasHit = jnp.isfinite(tMinAll)
  return idx, jnp.where(hasHit, t[idx], jnp.inf), hasHit


def hitNormal(table, idx, pWorld, dWorld):
  '''Outward-of-solid normal at the hit point, then oriented "forward"
  (non-negative dot with the travel direction) exactly like the reference's
  getNormal (ray.py:403-428). Returns (forwardNormal, isEntering).'''
  rot = table['w2lRot'][idx]
  off = table['w2lOff'][idx]
  pLocal = _matvec(rot, pWorld) + off
  nLocal = S.normalLocal(table['kind'][idx], table['params'][idx], pLocal)
  nWorld = _matvec(table['l2wRot'][idx], nLocal)
  outward = nWorld * table['orient'][idx]
  cosAngle = jnp.dot(dWorld, outward)
  isEntering = cosAngle < 0
  forward = jnp.where(isEntering, -outward, outward)
  return forward, isEntering
