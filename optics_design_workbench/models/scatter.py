'''
Stochastic scatter compilation: per-element Reflected/Refracted/
RayModification probability densities in (theta, phi), conditioned on the
incidence angle, pre-tabulated for on-device per-hit sampling.

The reference compiles one VectorRandomVariable per element and re-compiles
it PER HIT with theta_in/theta_refl substituted as constants, then draws a
single sample on the host (reference: optical_group.py:214-325) — fine for
per-ray Python, impossible in a batched device step. Here the conditional samplers are
tabulated over a grid of incidence angles at scene-compile time:

  phiInv   (Tin, Q)        inverse CDF of the phi marginal
  thetaInv (Tin, M, Q)     inverse CDF of theta | phi (M phi bins)
  + discrete (DiracDelta) event tables per variable

For lenses the ideal refraction angle theta_refr depends on the refraction
direction, so 'refract' builds two table sets (entering / exiting). TIR
angles fall back to the mirror angle, matching the reference's runtime
values. Scatter is applied by rotating the ideal outgoing direction:
out = Rot(normal, phiOut) Rot(normal x dIn, thetaOut) normal, then the
modify step rotates around the outgoing direction (optical_group.py:281-325).
'''

import numpy as np
import jax
import jax.numpy as jnp

from .. import distributions
from ..utils import io

THETA_IN_RES = 33
QUANTILE_RES = 257
PHI_COND_RES = 33
THETA_TAB_RES = 501

# scatter kind slots in the packed arrays
REFLECT, REFRACT_ENTER, REFRACT_EXIT, MODIFY = 0, 1, 2, 3
N_KINDS = 4


def _idealOutAngle(kind, thetaIn, n):
  '''theta of the ideal outgoing ray measured from the lobe axis: the
  incidence-side normal for reflection, the transmission-side (forward)
  normal for refraction. "theta=0 corresponds to the local face normal"
  (optical_group.py:44-58); with these axes a user's
  DiracDelta(theta - theta_refl) reproduces the ideal behavior exactly.'''
  if kind == REFLECT:
    return thetaIn        # specular: same angle on the incidence side
  mu = 1. / n if kind == REFRACT_ENTER else n
  s2 = (mu * np.sin(thetaIn)) ** 2
  if s2 >= 1:           # total internal reflection -> mirror angle, but the
    return np.pi - thetaIn  # lobe axis is the forward normal here
  return np.arccos(np.sqrt(1 - s2))


def _buildOneKind(density, thetaDomain, phiDomain, kind, n, dtype):
  '''Tabulate one scatter PDF over the incidence-angle grid. Returns a dict
  of stacked tables or None when the density is empty.'''
  if not density:
    return None
  thetaInGrid = np.linspace(0, np.pi / 2, THETA_IN_RES)
  # densities that never reference the incidence variables compile to the
  # SAME sampler for every grid row — build once and replicate (a per-row
  # compile costs seconds of sympy/numeric work x THETA_IN_RES = tens of
  # minutes for densities whose analytic attempt runs into the timeout)
  try:
    import sympy as sy
    free = {str(s) for s in
            sy.sympify(density.replace('^', '**')).free_symbols}
  except Exception:
    free = {'theta_in'}            # parse trouble: keep per-row compiles
  condDependent = bool(free & {'theta_in', 'phi_in', 'theta_refl',
                               'phi_refl'})
  phiInvs, thetaInvs = [], []
  thetaDiscV, thetaDiscC, phiDiscV, phiDiscC = [], [], [], []
  maxD = 0
  raws = []
  shared = None
  for thetaIn in thetaInGrid:
    if condDependent or shared is None:
      vrv = distributions.VectorRandomVariable(
          '(' + density + ')',
          variableOrder=('theta', 'phi'),
          variableDomains=dict(theta=tuple(thetaDomain),
                               phi=tuple(phiDomain)),
          numericalResolutions=dict(theta=THETA_TAB_RES, phi=PHI_COND_RES))
      # generous timeout: DiracDelta mixtures need the analytic path
      # (numeric tabulation cannot represent deltas), and sympy solves can
      # take seconds
      vrv.compile(timeout=20, theta_in=float(thetaIn), phi_in=0.,
                  theta_refl=float(_idealOutAngle(kind, thetaIn, n)),
                  phi_refl=0.)
      shared = distributions.buildDeviceTables(vrv, dtype=dtype,
                                               quantileRes=QUANTILE_RES)
    tabs = shared
    raws.append(tabs)
    tTheta, tPhi = tabs['tables'][0], tabs['tables'][1]
    phiInvs.append(np.asarray(tPhi['invCdf'][0]))
    thetaInvs.append(np.asarray(tTheta['invCdf']))
    for src, valList, cumList in ((tTheta, thetaDiscV, thetaDiscC),
                                  (tPhi, phiDiscV, phiDiscC)):
      v = np.asarray(src['discreteVals'])
      c = np.asarray(src['discreteCum'])
      valList.append(v)
      cumList.append(c)
      maxD = max(maxD, len(v))

  def pad(lists):
    # pad with the final element (cum rows must stay monotone and keep
    # their last value — zero padding would disable the discrete draw)
    return np.stack([np.concatenate(
        [x, np.full(maxD - len(x), x[-1] if len(x) else 0.)])
        for x in lists])

  npDtype = np.dtype(dtype.dtype if hasattr(dtype, 'dtype') else dtype)
  out = dict(
      phiInv=np.stack(phiInvs).astype(npDtype),
      thetaInv=np.stack(thetaInvs).astype(npDtype),
      phiGridLo=float(np.asarray(raws[0]['tables'][0]['laterGrids'][0])[0]),
      phiGridStep=float(np.diff(
          np.asarray(raws[0]['tables'][0]['laterGrids'][0])[:2])[0]),
      phiGridLen=int(raws[0]['tables'][0]['laterGrids'][0].shape[0]),
  )
  if maxD:
    out['thetaDiscVals'] = pad(thetaDiscV).astype(npDtype)
    out['thetaDiscCum'] = pad(thetaDiscC).astype(npDtype)
    out['phiDiscVals'] = pad(phiDiscV).astype(npDtype)
    out['phiDiscCum'] = pad(phiDiscC).astype(npDtype)
  return out


def buildScatterTables(groups, dtype=jnp.float32, devicePut=True):
  '''Build the scene-level scatter table pytree for a list of OpticalGroups,
  or None when no group defines any scatter density. All elements share one
  stacked table per kind; elements without a given kind get identity rows
  flagged off.'''
  anyScatter = any(g.scatterKinds() for g in groups)
  if not anyScatter:
    return None
  E = len(groups)
  perKind = {}
  flags = np.zeros((E, N_KINDS), dtype=bool)
  for e, g in enumerate(groups):
    kinds = g.scatterKinds()
    try:
      n = float(g.RefractiveIndex)
    except (TypeError, ValueError):
      n = g.refractiveIndexOf(550.)
    if 'reflect' in kinds:
      dens, tDom, pDom = kinds['reflect']
      perKind[(e, REFLECT)] = _buildOneKind(dens, tDom, pDom, REFLECT, n,
                                            dtype)
      flags[e, REFLECT] = True
    if 'refract' in kinds:
      dens, tDom, pDom = kinds['refract']
      perKind[(e, REFRACT_ENTER)] = _buildOneKind(dens, tDom, pDom,
                                                  REFRACT_ENTER, n, dtype)
      perKind[(e, REFRACT_EXIT)] = _buildOneKind(dens, tDom, pDom,
                                                 REFRACT_EXIT, n, dtype)
      flags[e, REFRACT_ENTER] = flags[e, REFRACT_EXIT] = True
    if 'modify' in kinds:
      dens, tDom, pDom = kinds['modify']
      perKind[(e, MODIFY)] = _buildOneKind(dens, tDom, pDom, MODIFY, n,
                                           dtype)
      flags[e, MODIFY] = True

  # assemble stacked (E, KINDS, ...) arrays; identity rows for absent kinds
  anyTab = next(iter(perKind.values()))
  Tin = anyTab['phiInv'].shape[0]
  Q = anyTab['phiInv'].shape[1]
  M = anyTab['thetaInv'].shape[1]
  maxD = max([t['thetaDiscVals'].shape[1] for t in perKind.values()
              if 'thetaDiscVals' in t] or [0])
  phiInv = np.zeros((E, N_KINDS, Tin, Q), dtype=np.float32)
  thetaInv = np.zeros((E, N_KINDS, Tin, M, Q), dtype=np.float32)
  discShape = (E, N_KINDS, Tin, maxD)
  tDiscV = np.zeros(discShape, dtype=np.float32)
  tDiscC = np.zeros(discShape, dtype=np.float32)
  pDiscV = np.zeros(discShape, dtype=np.float32)
  pDiscC = np.zeros(discShape, dtype=np.float32)
  meta = None
  for (e, kind), tab in perKind.items():
    if tab is None:
      flags[e, kind] = False
      continue
    if tab['thetaInv'].shape[1] != M or tab['phiInv'].shape[1] != Q:
      raise ValueError('inconsistent scatter table resolutions')
    phiInv[e, kind] = np.asarray(tab['phiInv'])
    thetaInv[e, kind] = np.asarray(tab['thetaInv'])
    if maxD and 'thetaDiscVals' in tab:
      d = tab['thetaDiscVals'].shape[1]
      for dst, src in ((tDiscV, 'thetaDiscVals'), (tDiscC, 'thetaDiscCum'),
                       (pDiscV, 'phiDiscVals'), (pDiscC, 'phiDiscCum')):
        dst[e, kind, :, :d] = np.asarray(tab[src])
        if 0 < d < maxD:
          # forward-fill so cum rows stay monotone with their final value
          dst[e, kind, :, d:] = dst[e, kind, :, d - 1:d]
    meta = tab

  # (lo, hi) pair rows: ONE 2-wide random gather per interpolation instead
  # of two scalar gathers (same trick as distributions/device_sampler
  # invCdfPairs)
  phiPairs = np.stack([phiInv[..., :-1], phiInv[..., 1:]],
                      axis=-1).reshape(-1, 2)
  thetaPairs = np.stack([thetaInv[..., :-1], thetaInv[..., 1:]],
                        axis=-1).reshape(-1, 2)
  npDtype = np.dtype(dtype.dtype if hasattr(dtype, 'dtype') else dtype)
  tables = dict(
      flags=flags,
      phiInv=phiInv,
      thetaInv=thetaInv,
      phiInvPairs=phiPairs.astype(npDtype),
      thetaInvPairs=thetaPairs.astype(npDtype),
      thetaInRes=np.float32(Tin),
      phiGridLo=np.float32(meta['phiGridLo']),
      phiGridStep=np.float32(meta['phiGridStep']),
      phiGridLen=np.int32(meta['phiGridLen']),
  )
  if maxD:
    tables.update(thetaDiscVals=tDiscV, thetaDiscCum=tDiscC,
                  phiDiscVals=pDiscV, phiDiscCum=pDiscC)
  io.verb(f'compiled scatter tables for {int(flags.any(axis=1).sum())} '
          f'element(s)')
  # ONE batched host->device transfer; devicePut=False keeps numpy for the
  # batched
  # sweep's host-side variant stacking
  return jax.device_put(tables) if devicePut else tables
