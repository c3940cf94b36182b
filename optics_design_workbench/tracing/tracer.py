'''
The ray-trace engine: a `lax.scan` over bounce depth whose body advances a
whole batch of rays through one intersection + interaction step.

Physics parity with the reference's per-ray generator `Ray.traceRay`
(reference: freecad_elements/ray.py:36-281):

  * nearest-intersection search with distance tolerance and same-medium
    tie-breaking (ray.py:290-401) — see geometry/intersect.py,
  * Mirror: specular reflection x Reflectivity (ray.py:146-161),
  * Lens: Snell refraction with entering/exiting medium tracking and total
    internal reflection (ray.py:165-211),
  * Grating: Ludwig-1970 diffraction, reflective or transmissive with
    order / lines-per-mm / line-orientation (ray.py:216-268, 445-487),
  * Absorber: power -> 0; Vacuum: pass-through detector (ray.py:271-277),
  * Beer-Lambert absorption along segments inside absorptive media
    (ray.py:120-125). NOTE one deliberate deviation: the reference
    *overwrites* the ray power with exp(-L/absLen) per segment; we
    *multiply*, which is the physically correct accumulation. Documented
    here because detector powers behind multiple absorbing media differ.
  * maxIntersections / maxRayLength / powerTol termination (ray.py:46-53,
    96-98, 280), sequential-mode per-bounce element masks
    (simulation_settings.py:46-53; find.py:79-104).

State is SoA: origins (N,3), directions (N,3), power (N,), wavelength (N,),
medium id (N,) int32 (-1 = vacuum), sequence index (N,), alive mask (N,).
Each bounce emits per-ray records (hits + segments) that the host converts
into the on-disk results contract.
'''

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..geometry import intersect as I
from ..geometry import transforms as T

# optical types (reference: optical_group.py:32)
MIRROR, LENS, GRATING, ABSORBER, VACUUM = 0, 1, 2, 3, 4
OPTICAL_TYPES = {'Mirror': MIRROR, 'Lens': LENS, 'Grating': GRATING,
                 'Absorber': ABSORBER, 'Vacuum': VACUUM}
GRATING_REFLECTION, GRATING_TRANSMISSION = 0, 1
VACUUM_MEDIUM = -1


def refractiveIndex(elements, elemIdx, wavelength):
  '''n(lambda) for an element: constant RefractiveIndex, or interpolated
  from a per-element dispersion table when present (extension over the
  reference's constant-only property, needed for dispersive glass).'''
  base = elements['refrIndex'][elemIdx]
  if 'nTable' in elements:
    row = elements['nTable'][elemIdx]
    disp = jnp.interp(wavelength, elements['nLambda'], row)
    hasDisp = elements['hasDispersion'][elemIdx]
    return jnp.where(hasDisp, disp, base)
  return base


def mirrorDirection(d, n):
  '''Specular reflection of unit d at normal n (reference: ray.py:430-434).'''
  return d - 2 * n * jnp.dot(d, n)


def snell(d, n, n1, n2):
  '''Snell's law with forward normal n (non-negative dot with d); returns
  (outDirection, isTotalReflection) (reference: ray.py:436-443).'''
  mu = n1 / n2
  cross = jnp.cross(n, d)
  root = 1 - mu * mu * jnp.dot(cross, cross)
  tir = root < 0
  tangential = jnp.cross(n, jnp.cross(-n, d))
  # double-where keeps sqrt'(0)=inf out of TIR rays' reverse-mode grads
  root = jnp.where(tir, 1., root)
  refracted = mu * tangential + n * jnp.where(tir, 0., jnp.sqrt(root))
  return jnp.where(tir, mirrorDirection(d, n), refracted), tir


def gratingDirection(d, n, n1, n2, wavelengthNm, order, linesPerMm,
                     linesOrientation, isReflection):
  '''Ludwig-1970 line-grating diffraction (reference: ray.py:445-487).
  `linesOrientation` is the normal of the hypothetical plane family whose
  intersections with the surface form the rulings. Evanescent orders
  (negative discriminant) are flagged so the caller can absorb the ray.

  Convention note: we evaluate Ludwig's formula with the incidence-side
  normal and without the reference's final negation (ray.py:487). This makes
  order 0 reduce *exactly* to specular reflection / Snell refraction at any
  incidence; the reference's form retro-reflects at order 0 and mirrors the
  tangential component at oblique incidence. For the symmetric setups of the
  reference's examples both agree up to the sign of the diffraction order.'''
  lam = wavelengthNm / 1000.  # nm -> um
  nInc = -n  # n is the forward normal; Ludwig uses the incidence-side one
  gVec = T.normalize(linesOrientation)
  P = T.normalize(jnp.cross(gVec, nInc))
  D = T.normalize(jnp.cross(nInc, P))
  mu = n1 / n2
  spacing = 1000. / linesPerMm  # um per line
  Tt = order * lam / (n1 * spacing)
  V = mu * jnp.dot(d, nInc)
  W = mu * mu - 1 + Tt * Tt - 2 * mu * Tt * jnp.dot(d, D)
  disc = V * V - W
  evanescent = disc < 0
  sq = jnp.where(evanescent, 0., jnp.sqrt(jnp.where(evanescent, 1., disc)))
  q = jnp.where(isReflection, -V + sq, -V - sq)
  out = mu * d - Tt * D + q * nInc
  return T.normalize(out), evanescent


def _beerLambert(elements, medium, power, segLen):
  '''Power after traversing segLen inside `medium` (multiplicative — see
  module docstring for the deviation from ray.py:120-125).'''
  inMedium = medium >= 0
  absLen = elements['absorptionLength'][jnp.maximum(medium, 0)]
  factor = jnp.where(absLen == 0, 0.,
                     jnp.where(jnp.isfinite(absLen),
                               jnp.exp(-segLen / jnp.maximum(absLen, 1e-30)),
                               1.))
  return jnp.where(inMedium, power * factor, power)


def bounceOne(scene, distTol, maxRayLength,
              o, d, power, wl, medium, seq, alive):
  '''One intersection + interaction step for a single ray (vmapped by the
  caller). Returns (newState, records).'''
  surf = scene['surfaces']
  elements = scene['elements']
  seqMask = scene.get('seqMask', None)

  # per-source ignore list (reference: generic_source.py IgnoredOpticalElements
  # via find.relevantOpticalObjects, find.py:79-104) and sequential-mode mask
  seqAllowed = scene.get('surfMask', None)
  if seqMask is not None:
    q = jnp.clip(seq, 0, seqMask.shape[0] - 1)
    allowed = seqMask[q]
    seqAllowed = allowed if seqAllowed is None else (allowed & seqAllowed)

  tAll = I.allDistances(surf, o, d, distTol, seqAllowed)
  idx, tHit, hasHit = I.selectNearest(tAll, surf['elem'], medium, distTol,
                                      maxRayLength)
  tSeg = jnp.where(hasHit, tHit, maxRayLength)
  point = o + tSeg * d
  elemIdx = surf['elem'][idx]

  n, isEntering = I.hitNormal(surf, idx, point, d)
  powerBefore = power
  power = _beerLambert(elements, medium, power, tSeg)

  # ---- interactions (all computed, selected by where) ----
  optType = elements['optType'][elemIdx]
  nElem = refractiveIndex(elements, elemIdx, wl)
  nMedium = jnp.where(medium >= 0,
                      refractiveIndex(elements, jnp.maximum(medium, 0), wl),
                      1.)

  dMirror = mirrorDirection(d, n)

  # lens refraction: entering medium' = elem, n2 = nElem; exiting n2 = 1
  n1 = nMedium
  n2 = jnp.where(isEntering, nElem, 1.)
  dSnell, tir = snell(d, n, n1, n2)

  # grating
  gType = elements['gratingType'][elemIdx]
  isRefl = gType == GRATING_REFLECTION
  gN1 = jnp.where(isRefl, nMedium, 1.)
  gN2 = jnp.where(isRefl, nMedium, nElem)
  dGrat, evanescent = gratingDirection(
      d, n, gN1, gN2, wl, elements['gratingOrder'][elemIdx],
      elements['gratingLpm'][elemIdx], elements['gratingDir'][elemIdx],
      isRefl)
  # transmission grating exiting = lens-like Snell (ray.py:245-265);
  # reflection grating exiting = pass-through (ray.py:227-229)
  gratDir = jnp.where(isRefl,
                      jnp.where(isEntering, dGrat, d),
                      jnp.where(isEntering, dGrat, dSnell))

  isMirror = optType == MIRROR
  isLens = optType == LENS
  isGrating = optType == GRATING
  isAbsorber = optType == ABSORBER

  newDir = jnp.where(isMirror, dMirror,
                     jnp.where(isLens, dSnell,
                               jnp.where(isGrating, gratDir, d)))
  newDir = T.normalize(newDir)

  # medium tracking (ray.py:165-211, 216-268)
  lensExitToVacuum = isLens & ~isEntering & ~tir & (medium == elemIdx)
  gratTransEnter = isGrating & ~isRefl & isEntering
  gratTransExit = isGrating & ~isRefl & ~isEntering & ~tir
  newMedium = jnp.where((isLens & isEntering) | gratTransEnter, elemIdx,
                        jnp.where(lensExitToVacuum | gratTransExit,
                                  VACUUM_MEDIUM, medium))

  newPower = jnp.where(isMirror, power * elements['reflectivity'][elemIdx],
                       jnp.where(isAbsorber, 0., power))
  # evanescent grating orders carry no propagating power
  newPower = jnp.where(isGrating & isEntering & evanescent, 0., newPower)

  seqInc = (isMirror | isAbsorber | (optType == VACUUM)
            | lensExitToVacuum
            | (isGrating & isRefl & isEntering)
            | gratTransExit).astype(seq.dtype)

  records = dict(
      hitElem=jnp.where(hasHit & alive, elemIdx, -1),
      hitSurface=jnp.where(hasHit & alive, idx, -1),
      point=point,
      direction=d,
      power=power,
      isEntering=isEntering,
      isHit=hasHit & alive,
      recordHit=hasHit & alive & elements['recordHits'][elemIdx],
      segValid=alive,
      segP1=o,
      segP2=point,
      segPower=powerBefore,
      segMedium=medium,
  )

  powerTol = scene.get('powerTol', 1e-6)
  newAlive = alive & hasHit & (newPower >= powerTol)
  newState = (point,
              jnp.where(hasHit, newDir, d),
              jnp.where(hasHit, newPower, power),
              wl,
              jnp.where(hasHit, newMedium, medium),
              seq + jnp.where(hasHit, seqInc, 0),
              newAlive)
  return newState, records


@partial(jax.jit, static_argnames=('maxIntersections', 'recordSegments'))
def trace(scene, origins, directions, powers, wavelengths,
          maxIntersections, maxRayLength, distTol, recordSegments=True,
          key=None):
  '''
  Trace a batch of rays to completion. Returns (finalState, records) where
  records is a dict of (maxIntersections, N, ...) arrays (bounce-major) —
  the batched analog of traceRay's per-segment yields (ray.py:36-281).
  With recordSegments=False only hit records are produced (cheaper for pure
  Monte-Carlo detector runs).
  '''
  from .batch_tracer import bounceBatch
  N = origins.shape[0]
  state = (origins, directions, powers, wavelengths,
           jnp.full((N,), VACUUM_MEDIUM, dtype=jnp.int32),
           jnp.zeros((N,), dtype=jnp.int32),
           jnp.ones((N,), dtype=bool))
  if key is None and 'scatter' in scene:
    key = jax.random.PRNGKey(0)
  keys = (None if key is None
          else jax.random.split(key, maxIntersections))

  def bounce(state, bounceKey):
    newState, rec = bounceBatch(scene, distTol, maxRayLength, *state,
                                key=bounceKey)
    if not recordSegments:
      rec = {k: v for k, v in rec.items()
             if not (k.startswith('seg') or k in ('oX', 'oY', 'oZ'))}
    return newState, rec

  # early exit: once every ray is dead the (expensive) intersection sweep
  # is skipped — essential when MaxIntersections is large (the reference
  # default is 100, ray.py:96-98) but typical scenes finish in ~6 bounces
  recSpec = jax.eval_shape(
      bounce, state, keys[0] if keys is not None else None)[1]
  zeroRec = {k: (jnp.full(v.shape, -1, v.dtype)
                 if k in ('hitElem', 'hitSurface')
                 else jnp.zeros(v.shape, v.dtype))
             for k, v in recSpec.items()}

  def body(state, bounceKey):
    return lax.cond(
        jnp.any(state[6]),
        lambda s: bounce(s, bounceKey),
        lambda s: (s, zeroRec),
        state)

  finalState, rec = lax.scan(body, state, keys, length=maxIntersections)

  # assemble the stacked record views the host-side consumers expect
  records = dict(
      hitElem=rec['hitElem'], hitSurface=rec['hitSurface'],
      point=jnp.stack([rec['px'], rec['py'], rec['pz']], axis=-1),
      direction=jnp.stack([rec['dirX'], rec['dirY'], rec['dirZ']], axis=-1),
      power=rec['power'], isEntering=rec['isEntering'],
      isHit=rec['isHit'], recordHit=rec['recordHit'])
  if recordSegments:
    records.update(
        segValid=rec['segValid'],
        segP1=jnp.stack([rec['oX'], rec['oY'], rec['oZ']], axis=-1),
        segP2=records['point'],
        segPower=rec['segPower'], segMedium=rec['segMedium'])
  return finalState, records


def traceReference(scene, origins, directions, powers, wavelengths,
                   maxIntersections, maxRayLength, distTol):
  '''The per-ray oracle: `bounceOne` vmapped over the batch, bounce by
  bounce, with every matrix product at full f32 precision. Returns
  bounce-major (maxIntersections, N, ...) records hitElem, point, power,
  isHit. Scenes with stochastic scatter are not supported (bounceOne has
  no scatter draw).'''
  N = origins.shape[0]
  state = (origins, directions, powers, wavelengths,
           jnp.full((N,), VACUUM_MEDIUM, dtype=jnp.int32),
           jnp.zeros((N,), dtype=jnp.int32),
           jnp.ones((N,), dtype=bool))
  step = jax.vmap(partial(bounceOne, scene, distTol, maxRayLength))

  @jax.jit
  def run(state):
    def body(state, _):
      newState, rec = step(*state)
      return newState, dict(hitElem=rec['hitElem'], point=rec['point'],
                            power=rec['power'], isHit=rec['isHit'])
    return lax.scan(body, state, None, length=maxIntersections)[1]

  with jax.default_matmul_precision('highest'):
    return run(state)


def totalSegments(records):
  '''Number of traced ray-segments (the benchmark unit). int32 is explicit:
  per-call record arrays are bounded by maxIntersections * batch (< 2^31);
  callers accumulate across calls in python ints.'''
  key = 'segValid' if 'segValid' in records else 'isHit'
  return jnp.sum(records[key].astype(jnp.int32))
