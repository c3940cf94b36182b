'''
Differentiable scene parameters — gradient-based optical design.

The reference optimizes designs with derivative-free scipy searches over
FreeCAD document properties, re-running the whole simulation per probe
(reference: jupyter_utils/parameter_sweeper.py:700-918, methods
'COBYQA'/'Nelder-Mead'/'Powell'). Because this framework's tracer is pure
JAX, the merit function can instead be DIFFERENTIATED: `applyParams`
functionally rewrites a compiled device scene as a jnp function of a
parameter vector (all redundant table views updated consistently), so
`jax.value_and_grad(loss)` backpropagates through the full multi-bounce
trace — Snell refraction, mirror folds, grating dispersion — and a
first-order optimizer (optax) converges in tens of steps where the
reference needs hundreds of simulations. This capability has no reference
analog; it exists because this design makes the physics a
closed differentiable program.

Parameter specs (each consumes one entry of the parameter vector p):
  ('translate',    surfIdx, axis)       world-space translation along the
                                        (normalized) axis by p
  ('rotate',       surfIdx, axis, pivot) rotation by p radians about the
                                        world axis through pivot
  ('surfaceParam', surfIdx, paramIdx)   additive offset on a surface
                                        parameter (radius, curvature,
                                        conic, quadric coeff, ...)
  ('refrIndex',    elemIdx)             additive offset on an element's
                                        refractive index
  ('translateGroup', elemIdx, axis)     rigid-body translation of EVERY
                                        surface of an element by one p
  ('rotateGroup', elemIdx, axis, pivot[, 'coRotateRuling'])
                                        rigid-body rotation of an element;
                                        the optional 5th entry also
                                        rotates a grating's ruling vector
                                        (the reference keeps
                                        GratingLinesOrientation
                                        world-fixed, ray.py:449)

Limitations (raised where detectable): transforms must be rigid (they
are — placements and OCC locations are rotation+translation); 'refrIndex'
rejects elements with a dispersion table (it would mask the constant
index); trims are not trainable.
'''

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import surfaces as GS
from .element_table import EP_REFRINDEX, EP_GRATDIRX
from .tracer import GRATING


_LAYOUT_CACHE = {}


def _mm(a, b):
  '''Full-f32 matrix product: a GPU may otherwise run an f32 product in
  TF32 (about 3 decimal digits), which would perturb the rigid transforms
  being differentiated.'''
  return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _kindLayout(scene):
  '''Host-side static layout: per table row its kind name and local index
  inside the kind-sorted byKind slice (surfaces.buildSurfaceTable sorts by
  kind; slices are contiguous). Cached per table identity, so the 'kind'
  array is fetched from the device at most once per scene.'''
  key = id(scene['surfaces']['packed'])
  cached = _LAYOUT_CACHE.get(key)
  if cached is not None:
    return cached
  kinds = np.asarray(scene['surfaces']['kind'])
  layout = []
  for i, k in enumerate(kinds.tolist()):
    name = GS._KIND_NAMES[int(k)]
    layout.append((name, int((kinds[:i] == k).sum())))
  _LAYOUT_CACHE[key] = layout
  return layout


def _hostElems(scene):
  '''(S,) element ids as numpy, preferring the host copy buildSurfaceTable
  keeps exactly so callers never pay a device fetch.'''
  he = scene['surfaces'].get('_hostElem')
  return np.asarray(he if he is not None else scene['surfaces']['elem'])


def _rotationMatrix(axis, angle):
  '''Rodrigues rotation matrix (3, 3) for a unit axis, jnp/differentiable.'''
  x, y, z = axis
  c, s = jnp.cos(angle), jnp.sin(angle)
  C = 1. - c
  return jnp.array([
      [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
      [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
      [z * x * C - y * s, z * y * C + x * s, c + z * z * C]])


def applyParams(scene, specs, p):
  '''Return a new scene pytree with the parameter vector `p` applied.
  Pure jnp (`.at[...]` functional updates) — safe to jit and differentiate.
  Every redundant view of the surface table is updated: the flat arrays,
  the packed per-surface row (geometry/surfaces.py PACKED_* layout) and
  the per-kind byKind slice the intersection sweep reads.'''
  surf = dict(scene['surfaces'])
  byKind = {k: dict(v) for k, v in surf['byKind'].items()}
  elements = dict(scene['elements'])
  layout = _kindLayout(scene)
  p = jnp.asarray(p)

  def setSurfTransform(i, l2wRot, l2wOff):
    # rigid inverse: w2l = (R^T, -R^T t)
    w2lRot = l2wRot.T
    w2lOff = -_mm(w2lRot, l2wOff)
    dt = surf['w2lRot'].dtype
    surf['l2wRot'] = surf['l2wRot'].at[i].set(l2wRot.astype(dt))
    surf['l2wOff'] = surf['l2wOff'].at[i].set(l2wOff.astype(dt))
    surf['w2lRot'] = surf['w2lRot'].at[i].set(w2lRot.astype(dt))
    surf['w2lOff'] = surf['w2lOff'].at[i].set(w2lOff.astype(dt))
    pk = surf['packed'].dtype
    surf['packed'] = surf['packed'] \
        .at[i, GS.PACKED_ROT:GS.PACKED_ROT + 9] \
        .set(w2lRot.reshape(9).astype(pk)) \
        .at[i, GS.PACKED_OFF:GS.PACKED_OFF + 3].set(w2lOff.astype(pk))
    name, local = layout[i]
    byKind[name]['w2lRot'] = byKind[name]['w2lRot'] \
        .at[local].set(w2lRot.astype(dt))
    byKind[name]['w2lOff'] = byKind[name]['w2lOff'] \
        .at[local].set(w2lOff.astype(dt))

  elemArr = _hostElems(scene)

  def rotateGratingDir(e, axis, angle):
    # a rotated grating must carry its ruling direction along or the
    # Ludwig diffraction runs against a stale world-space vector
    a = np.asarray(axis, dtype=float)
    R = _rotationMatrix(tuple(a / np.linalg.norm(a)), angle)
    newDir = _mm(R, elements['gratingDir'][e])
    elements['gratingDir'] = elements['gratingDir'].at[e].set(newDir)
    elements['packed'] = elements['packed'] \
        .at[e, EP_GRATDIRX:EP_GRATDIRX + 3].set(
            newDir.astype(elements['packed'].dtype))

  def translateOne(i, axis, t):
    a = np.asarray(axis, dtype=float)
    a = jnp.asarray(a / np.linalg.norm(a))
    setSurfTransform(i, surf['l2wRot'][i], surf['l2wOff'][i] + t * a)

  def rotateOne(i, axis, pivot, angle):
    a = np.asarray(axis, dtype=float)
    a = a / np.linalg.norm(a)
    q = jnp.asarray(pivot)
    R = _rotationMatrix(tuple(a), angle)
    setSurfTransform(i, _mm(R, surf['l2wRot'][i]),
                     q + _mm(R, surf['l2wOff'][i] - q))

  for k, spec in enumerate(specs):
    kind = spec[0]
    if kind == 'translate':
      translateOne(spec[1], spec[2], p[k])
    elif kind == 'rotate':
      rotateOne(spec[1], spec[2], spec[3], p[k])
    elif kind in ('translateGroup', 'rotateGroup'):
      rows = np.nonzero(elemArr == spec[1])[0]
      if not len(rows):
        raise ValueError(f'{kind} spec: no surfaces belong to element '
                         f'{spec[1]} (labels are kind-sorted table rows; '
                         f'check info["elementLabels"])')
      for i in rows:
        if kind == 'translateGroup':
          translateOne(int(i), spec[2], p[k])
        else:
          rotateOne(int(i), spec[2], spec[3], p[k])
      if kind == 'rotateGroup' and len(spec) > 4 and spec[4]:
        # opt-in ruling co-rotation: the reference treats
        # GratingLinesOrientation as a WORLD-FIXED property (ray.py:449
        # reads it raw, never placement-transformed), so the default here
        # matches recompiling with a rotated placement; pass
        # ('rotateGroup', e, axis, pivot, 'coRotateRuling') when the
        # physical intent is rulings etched on the rotating element
        if int(np.asarray(scene['elements'].get(
            '_hostOptType', scene['elements']['optType']))[spec[1]]) \
            != GRATING:
          raise ValueError(f'coRotateRuling on non-grating element '
                           f'{spec[1]}')
        rotateGratingDir(spec[1], spec[2], p[k])
    elif kind == 'surfaceParam':
      _, i, j = spec
      newVal = surf['params'][i, j] + p[k]
      surf['params'] = surf['params'].at[i, j].set(newVal)
      surf['packed'] = surf['packed'] \
          .at[i, GS.PACKED_PARAMS + j].set(newVal)
      name, local = layout[i]
      byKind[name]['params'] = byKind[name]['params'] \
          .at[local, j].set(newVal)
    elif kind == 'refrIndex':
      _, e = spec
      if 'nTable' in elements and bool(np.asarray(
          elements.get('hasDispersion'))[e]):
        raise ValueError(f'refrIndex spec on element {e}: it has a '
                         f'dispersion table, which masks the constant '
                         f'index (batch_tracer nElem) — the parameter '
                         f'would silently have zero gradient')
      newN = elements['refrIndex'][e] + p[k]
      elements['refrIndex'] = elements['refrIndex'].at[e].set(newN)
      elements['packed'] = elements['packed'] \
          .at[e, EP_REFRINDEX].set(newN)
    else:
      raise ValueError(f'unknown parameter spec kind {kind!r}')

  surf['byKind'] = byKind
  out = dict(scene)
  out['surfaces'] = surf
  out['elements'] = elements
  return out


def makeSpotLoss(scene, specs, batch, detectorElem, maxIntersections,
                 maxRayLength=1e6, distTol=1e-4, powerTol=1e-6,
                 missRadius=100.):
  '''Jitted `value_and_grad` of the power-weighted RMS spot radius on
  `detectorElem` for a FIXED ray batch — the classic focusing merit
  (reference notebooks minimize the same quantity by derivative-free
  search, examples/3-parameter-sweeps). batch: dict with origins /
  directions / powers / wavelengths arrays.

  The gradient backpropagates through the whole bounce scan: nearest-hit
  selection is piecewise-constant (treated as fixed at the selected
  branch, the standard differentiable-ray-tracing convention), while hit
  positions, Snell directions and Beer-Lambert powers are smooth.

  Rays that MISS the detector contribute `missRadius` to the RMS (at
  their launch power): without this, moving the detector out of the beam
  zeroes the merit and gradient descent happily "wins" by losing every
  ray. The miss term's gradient is zero (the hit set is discrete), but
  the value landscape keeps degenerate geometries from ever being the
  reported best.'''
  from .tracer import trace
  sc0 = dict(scene)
  sc0['powerTol'] = powerTol
  origins = jnp.asarray(batch['origins'])
  directions = jnp.asarray(batch['directions'])
  powers = jnp.asarray(batch['powers'])
  wavelengths = jnp.asarray(batch['wavelengths'])

  def loss(p):
    sc = applyParams(sc0, specs, p)
    _state, rec = trace(sc, origins, directions, powers, wavelengths,
                        maxIntersections=maxIntersections,
                        maxRayLength=maxRayLength, distTol=distTol,
                        recordSegments=False)
    m = (rec['recordHit'] & (rec['hitElem'] == detectorElem))
    w = jnp.where(m, rec['power'], 0.)
    wSum = jnp.maximum(w.sum(), 1e-12)
    pts = rec['point']
    centroid = (w[..., None] * pts).sum(axis=(0, 1)) / wSum
    # zero the contribution of non-hits BEFORE the square so their
    # (arbitrary) positions can't leak NaN/garbage into the gradient
    d = jnp.where(m[..., None], pts - centroid, 0.)
    # rays never reaching the detector count as missRadius at launch power
    missW = jnp.where(m.any(axis=0), 0., powers)
    num = (w * (d * d).sum(-1)).sum() + (missW * missRadius ** 2).sum()
    den = wSum + missW.sum()
    return jnp.sqrt(num / den + 1e-18)

  return jax.jit(jax.value_and_grad(loss))


def optimizeGradient(lossGrad, p0, steps=100, learningRate=None,
                     optimizer=None, callback=None):
  '''Minimize a jitted value_and_grad function with optax (adam by
  default). Returns (bestP, history list of (step, value)). Host-side
  loop: each step is one compiled forward+backward pass on device.'''
  import optax
  if optimizer is None:
    optimizer = optax.adam(1e-1 if learningRate is None else learningRate)
  p = jnp.asarray(p0, dtype=float)
  state = optimizer.init(p)
  best, bestP = np.inf, p
  history = []
  for step in range(int(steps)):
    value, grad = lossGrad(p)
    value = float(value)
    history.append((step, value))
    if value < best:
      best, bestP = value, p
    if callback is not None:
      callback(step, value, p)
    updates, state = optimizer.update(grad, state, p)
    p = optax.apply_updates(p, updates)
  return bestP, history
