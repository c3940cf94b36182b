'''The fused sample+trace+histogram step (tracing/fused.makeFusedStep, the
one device path of histogram-mode runs, benchmarks and sweeps) against the
record-producing tracer (tracing.trace) plus host-side binning, on the same
rays: one case per scene class the device path has to support — gratings,
quadrics, stacked pass-through detectors, sequential mode, the three
scatter-lobe classes, trimmed faces, triangle meshes (small, and past 1,024
triangles), many-surface scenes, tori, surface sources and dispersive
glass. Deterministic scenes must agree bin for bin. Scatter scenes agree
statistically: the fused step draws lobes from fitted polynomials
(batch_tracer.scatterConstants) where the record path gathers from the
tabulated inverse CDFs, so their row and column marginals must agree
within Monte-Carlo error.
'''

import math

import numpy as np
import jax
import pytest

from optics_design_workbench.models import (Scene, PointSource,
                                            OpticalGroup, SurfaceSource)
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench.tracing import fused, trace

N = 1 << 11
N_SCATTER = 1 << 13
BINS = (32, 64)
SCATTER_CASES = ('uniform_scatter', 'conditioned_dirac_scatter',
                 'coupled_scatter')


def _pointSource(density, thetaDomain, **kw):
  return PointSource(Label='Src', PowerDensity=density,
                     ThetaDomain=thetaDomain, Wavelength=kw.pop('wl', 532.),
                     ThetaResolutionNumericMode='1e3', **kw)


def _farSphere(radius=300.):
  return OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.sphere(np.eye(4), elem=0, radius=radius, orient=-1)],
      placements=[np.eye(4)])


def _floor(half=300., z=0.):
  return OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(half, half))],
      placements=[T.translation(0, 0, z)])


def _grating():
  scene = Scene(label='grat')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Grating', Label='Grat', GratingType='Reflection',
      GratingLinesPerMillimeter=600., GratingDiffractionOrder=1,
      GratingLinesOrientation=(1., 0., 0.),
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(30., 30.))],
      placements=[T.compose(T.translation(0, 0, 100),
                            T.rotation((1, 0, 0), 20))]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.sphere(T.translation(0, 0, 100), elem=0, radius=300.,
                         orient=-1)],
      placements=[np.eye(4)]))
  scene.addSource(_pointSource('exp(-theta^2/0.005)', '0, 0.2'))
  return scene, 300., 3, 0.5


def _quadricLens():
  scene = Scene(label='quad')
  ell = np.array([1. / 400., 1. / 900., 1. / 225., 0., -1.])
  ell = ell / ell[:3].max()
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Lens', Label='Lens', RefractiveIndex=1.6,
      surfaces=[S.quadric(T.translation(0, 0, 40), elem=0,
                          coeffs=tuple(ell), zRange=(10., 15.)),
                S.plane(np.eye(4), elem=0, radius=16., orient=-1)],
      placements=[T.translation(0, 0, 50)]))
  scene.addOpticalGroup(_floor(100.))
  scene.addSource(_pointSource(
      'exp(-theta^2/0.05)', '0, 0.35',
      placement=T.compose(T.translation(0, 0, 120),
                          T.rotation((1, 0, 0), 180))))
  return scene, 100., 6, 0.25


def _stackedDetectors():
  scene = Scene(label='stack')
  for i, z in enumerate((40., 60.)):
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Vacuum', Label=f'Det{i}', RecordHits=True,
        surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(50., 50.))],
        placements=[T.translation(0, 0, z)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Back',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(50., 50.))],
      placements=[T.translation(0, 0, 90.)]))
  scene.addSource(_pointSource('exp(-theta^2/0.02)', '0, 0.3'))
  return scene, 50., 8, 3.5


def _sequentialLens():
  scene = Scene(label='seqlens')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Lens', Label='Ball', RefractiveIndex=1.5,
      surfaces=[S.sphere(np.eye(4), elem=0, radius=10.)],
      placements=[T.translation(0, 0, 30.)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det', RecordHits=True,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(80., 80.))],
      placements=[T.translation(0, 0, 80.)]))
  scene.addSource(_pointSource('exp(-theta^2/0.02)', '0, 0.25'))
  scene.addSimulationSettings(SequentialMode=True,
                              SequentialModeElements=[['Ball'], ['Det']])
  return scene, 80., 5, 0.9


def _diffuser(density, **kw):
  scene = Scene(label='scat')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Diffuser', Reflectivity=1.0,
      ReflectedProbabilityDensity=density,
      surfaces=[S.plane(np.eye(4), elem=0, radius=50., orient=-1)],
      placements=[T.translation(0, 0, 50)], **kw))
  scene.addOpticalGroup(_floor(500.))
  return scene


def _uniformScatter():
  scene = _diffuser('exp(-theta^2/0.02)', PowerThetaDomain='0, pi/3')
  scene.addSource(_pointSource('1', '0, 0.01',
                               placement=T.translation(0, 0, 1e-3)))
  return scene, 100., 4, 0.5


def _conditionedDiracScatter():
  scene = _diffuser('DiracDelta(theta-theta_refl)'
                    ' + 5*exp(-(theta-theta_in)**2/0.02)',
                    PowerThetaDomain='0, pi/2', PowerPhiDomain='0, 2*pi')
  scene.addSource(_pointSource('1', '0, 0.4',
                               placement=T.translation(0, 0, 1e-3)))
  return scene, 150., 4, 0.3


def _coupledScatter():
  scene = _diffuser('exp(-(theta*cos(phi))**2/0.003'
                    ' - (theta*sin(phi))**2/0.05)',
                    PowerThetaDomain='0, pi/3', PowerPhiDomain='0, 2*pi')
  scene.addSource(_pointSource('1', '0, 0.01',
                               placement=T.translation(0, 0, 1e-3)))
  return scene, 100., 4, 0.5


def _slotBitmap(R=64, rDisc=20., slotHalf=2., window=25.):
  ax = (np.arange(R) + .5) / R * (2 * window) - window
  X, Y = np.meshgrid(ax, ax)
  mask = ((X ** 2 + Y ** 2 <= rDisc ** 2)
          & (np.abs(X) >= slotHalf)).astype(np.uint8)
  return dict(mask=mask, u0=-window, v0=-window,
              invDu=R / (2 * window), invDv=R / (2 * window))


def _bitmapPlane():
  scene = Scene(label='bitmap')
  slotted = S.plane(np.eye(4), elem=0, halfExtents=(25., 25.))
  slotted['trimBitmap'] = _slotBitmap()
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Slotted', surfaces=[slotted],
      placements=[T.translation(0, 0, 50)]))
  scene.addOpticalGroup(_farSphere())
  scene.addSource(_pointSource('exp(-theta^2/0.1)', '0, 0.45'))
  return scene, 300., 4, 0.9


def _bitmapAzimuthChart():
  R = 64
  u = (np.arange(R) + .5) / R * (2 * np.pi) - np.pi
  ax = (np.arange(R) + .5) / R * 40. - 20.
  U, Z = np.meshgrid(u, ax)
  mask = ((np.abs(U) <= np.pi / 2) & (np.abs(Z) <= 15.)).astype(np.uint8)
  cyl = S.cylinder(np.eye(4), elem=0, radius=30., zRange=(-20., 20.))
  cyl['trimBitmap'] = dict(mask=mask, u0=-np.pi, v0=-20.,
                           invDu=R / (2 * np.pi), invDv=R / 40.)
  scene = Scene(label='azbitmap')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='HalfPipe', surfaces=[cyl],
      placements=[T.compose(T.translation(0, 0, 60),
                            T.rotation((1, 0, 0), 90))]))
  scene.addOpticalGroup(_farSphere())
  scene.addSource(_pointSource('exp(-theta^2/0.1)', '0, 0.5'))
  return scene, 300., 4, 0.9


def _trimPrims():
  scene = Scene(label='prims')
  slotted = S.plane(np.eye(4), elem=0, radius=22.)
  slotted['trim'][0] = 3.                      # annulus base + prims
  ang = np.deg2rad(30.)
  slotted['trimPrims'] = dict(holes=[
      (1., 0.5, -0.25, 1e7, 2.2, float(np.cos(ang)), float(np.sin(ang))),
      (3., 14., 14., 1., 1., 0., 0.),
  ])
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Slotted', surfaces=[slotted],
      placements=[T.translation(0, 0, 50)]))
  scene.addOpticalGroup(_farSphere())
  scene.addSource(_pointSource('exp(-theta^2/0.1)', '0, 0.45'))
  return scene, 300., 4, 0.9


def _triangleMesh():
  scene = Scene(label='tri')
  c, s = math.cos(math.radians(45.)), math.sin(math.radians(45.))

  def pt(x, y):
    return (x, y * c, 60. + y * s)
  tris = [S.triangle(pt(-25, -25), pt(25, -25), pt(25, 25), elem=0),
          S.triangle(pt(-25, -25), pt(25, 25), pt(-25, 25), elem=0)]
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='FoldTri', surfaces=tris,
      placements=[np.eye(4)]))
  scene.addOpticalGroup(_farSphere())
  scene.addSource(_pointSource('exp(-theta^2/0.05)', '0, 0.3'))
  return scene, 300., 3, 0.9


def _manySurfaces():
  scene = Scene(label='manysurf')
  side, k = 9, 0
  for i in range(side):
    for j in range(side):
      if k >= 80:
        break
      x = (i - side / 2 + .5) * 12.
      y = (j - side / 2 + .5) * 12.
      scene.addOpticalGroup(OpticalGroup(
          OpticalType='Mirror', Label=f'M{k}', Reflectivity=0.95,
          surfaces=[S.plane(np.eye(4), elem=0, radius=6.)],
          placements=[T.compose(T.translation(x, y, 50.),
                                T.rotation((0, 1, 0), 45.))]))
      k += 1
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(500., 500.))],
      placements=[T.compose(T.translation(-200., 0., 50.),
                            T.rotation((0, 1, 0), 90.))]))
  scene.addSource(_pointSource('exp(-theta^2/0.5)', '0, 0.9'))
  return scene, 300., 3, 0.05


def _shellMesh():
  '''A 1,368-triangle spherical shell reflecting back onto a floor.'''
  scene = Scene(label='shell')
  nT, nP, R0 = 26, 27, 50.

  def pt(it, ip):
    th = math.pi * 0.55 * it / nT
    ph = 2 * math.pi * ip / nP
    return (R0 * math.sin(th) * math.cos(ph),
            R0 * math.sin(th) * math.sin(ph),
            60. + R0 * (1. - math.cos(th)))
  tris = []
  for it in range(nT):
    for ip in range(nP):
      a, b = pt(it, ip), pt(it + 1, ip)
      c, d = pt(it + 1, ip + 1), pt(it, ip + 1)
      if it:
        tris.append(S.triangle(a, b, c, elem=0))
      tris.append(S.triangle(a, c, d, elem=0))
  assert len(tris) > 1024
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Shell', surfaces=tris,
      placements=[np.eye(4)]))
  scene.addOpticalGroup(_floor())
  scene.addSource(_pointSource('exp(-theta^2/0.2)', '0, 0.6',
                               placement=T.translation(0, 0, 1e-3)))
  return scene, 300., 3, 0.2


def _torus(vRange=None, thetaDomain='0.15, 0.55', mean=0.38, width=0.01,
           half=200.):
  scene = Scene(label='torus')
  kw = {} if vRange is None else dict(vRange=vRange)
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Ring',
      surfaces=[S.torus(np.eye(4), elem=0, majorRadius=30., minorRadius=8.,
                        **kw)],
      placements=[T.translation(0, 0, 80.)]))
  scene.addOpticalGroup(_floor(half))
  scene.addSource(_pointSource(f'exp(-(theta-{mean})^2/{width})',
                               thetaDomain))
  return scene, half, 3, 0.1


def _torusMirror():
  return _torus()


def _torusVBand():
  scene, half, maxI, _ = _torus(vRange=(-1.5707, 1.5707),
                                thetaDomain='0.2, 0.7', mean=0.44,
                                width=0.02, half=400.)
  return scene, half, maxI, 0.01


def _surfaceSource():
  scene = Scene(label='ss')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Emitter',
      surfaces=[S.plane(np.eye(4), elem=0, radius=5.)],
      placements=[T.translation(0, 0, 0.5)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Fold', Reflectivity=0.9,
      surfaces=[S.plane(np.eye(4), elem=0, radius=80.)],
      placements=[T.compose(T.translation(0, 0, 60.),
                            T.rotation((0, 1, 0), 45.))]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(300., 300.))],
      placements=[T.compose(T.translation(-120., 0., 60.),
                            T.rotation((0, 1, 0), 90.))]))
  scene.addSource(SurfaceSource(Label='SS', ActiveSurfaces=['Emitter'],
                                PowerDensity='cos(theta)**2',
                                ThetaDomain='0, 0.6', Wavelength=532.))
  return scene, 300., 4, 0.5


def _dispersiveLens():
  '''A prism-like wedge of Cauchy glass: the exit angle, and with it the
  detector row, depends on n(lambda) interpolated from the table.'''
  scene = Scene(label='disp')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Lens', Label='Wedge',
      RefractiveIndex='1.5 + 4000/wavelength^2',
      surfaces=[S.plane(T.translation(0, 0, 0), elem=0, radius=40.,
                        orient=-1),
                S.plane(T.compose(T.translation(0, 0, 10),
                                  T.rotation((1, 0, 0), 20)),
                        elem=0, radius=40., orient=+1)],
      placements=[T.translation(0, 0, 40)]))
  scene.addOpticalGroup(_floor(150., z=200.))
  scene.addSource(_pointSource('exp(-theta^2/0.002)', '0, 0.1', wl=450.))
  return scene, 150., 5, 0.8


CASES = dict(
    grating=_grating, quadric_lens=_quadricLens,
    stacked_detectors=_stackedDetectors, sequential_lens=_sequentialLens,
    uniform_scatter=_uniformScatter,
    conditioned_dirac_scatter=_conditionedDiracScatter,
    coupled_scatter=_coupledScatter, bitmap_plane=_bitmapPlane,
    bitmap_azimuth_chart=_bitmapAzimuthChart, trim_prims=_trimPrims,
    triangle_mesh=_triangleMesh, many_surfaces=_manySurfaces,
    mesh_past_1024=_shellMesh, torus_mirror=_torusMirror,
    torus_vband_trim=_torusVBand, surface_source=_surfaceSource,
    dispersive_lens=_dispersiveLens)


def _hostBin(rec, device, elemToDet, bounds, bins):
  '''np.add.at binning of the recorded hits in each recording surface's
  local (x, y) frame — the host mirror of the fused step's scatter-add.'''
  H, W = bins
  D = bounds.shape[0]
  power = np.zeros((D, H, W))
  counts = np.zeros((D, H, W))
  hitElem = np.asarray(rec['hitElem'])
  mask = np.asarray(rec['recordHit']) & (hitElem >= 0)
  det = elemToDet[np.maximum(hitElem, 0)]
  mask &= det >= 0
  pts = np.asarray(rec['point'], np.float64)[mask]
  pw = np.asarray(rec['power'], np.float64)[mask]
  dd = det[mask]
  sIdx = np.asarray(rec['hitSurface'])[mask]
  rot = np.asarray(device['surfaces']['w2lRot'], np.float64)[sIdx]
  off = np.asarray(device['surfaces']['w2lOff'], np.float64)[sIdx]
  local = np.einsum('nij,nj->ni', rot, pts) + off
  b = bounds[dd]
  fx = (local[:, 0] - b[:, 0]) / (b[:, 1] - b[:, 0])
  fy = (local[:, 1] - b[:, 2]) / (b[:, 3] - b[:, 2])
  ok = (fx >= 0) & (fx < 1) & (fy >= 0) & (fy < 1)
  ix = np.clip((fx[ok] * W).astype(int), 0, W - 1)
  iy = np.clip((fy[ok] * H).astype(int), 0, H - 1)
  np.add.at(power, (dd[ok], iy, ix), pw[ok])
  np.add.at(counts, (dd[ok], iy, ix), 1.)
  return power, counts


def _marginalsL1(hA, hB):
  '''Largest L1 distance between the normalized row and column marginals
  of two count histograms (summed over detectors).'''
  a, b = hA.sum(axis=0), hB.sum(axis=0)
  return max(float(np.abs(a.sum(axis=ax) / a.sum()
                          - b.sum(axis=ax) / b.sum()).sum())
             for ax in (0, 1))


@pytest.mark.parametrize('case', sorted(CASES))
def test_fused_step_matches_trace_oracle(case):
  scene, half, maxI, minHitsPerRay = CASES[case]()
  n = N_SCATTER if case in SCATTER_CASES else N
  device, info = scene.compile()
  device['powerTol'] = 1e-6
  src = scene.lightSources()[0]
  histSpec = fused.makeHistogramSpec(device, info,
                                     bounds=(-half, half, -half, half),
                                     bins=BINS)
  key = jax.random.PRNGKey(11)
  kw = dict(maxIntersections=maxI, maxRayLength=1e6, distTol=1e-4)
  step = fused.makeFusedStep(device, src.deviceGenerator(), histSpec,
                             raysPerStep=n, **kw)
  hist, counters = step(key, fused.initHistograms(histSpec))

  batch = src.deviceGenerator()(key, n)
  _state, rec = trace(device, batch['origins'], batch['directions'],
                      batch['powers'], batch['wavelengths'],
                      recordSegments=False,
                      key=jax.random.PRNGKey(0) if 'scatter' in device
                      else None, **kw)
  refPower, refCounts = _hostBin(
      rec, device, np.asarray(histSpec['elemToDet']),
      np.asarray(histSpec['bounds'], np.float64), BINS)

  counts = np.asarray(hist['counts'])
  hits = int(counters['hits'])
  assert hits >= minHitsPerRay * n, (hits, case)
  assert hits == int(counts.sum())
  if case in SCATTER_CASES:
    # independent lobe draws: marginals within the Monte-Carlo noise floor
    assert abs(hits - int(refCounts.sum())) <= 0.02 * n
    assert _marginalsL1(counts, refCounts) <= 0.15, case
    return
  # the same rays hit the same bins: only a ray within an ulp of a bin edge
  # may land one bin over (device f32 vs host f64 local coordinates)
  assert abs(hits - int(refCounts.sum())) <= 2
  assert np.abs(counts - refCounts).sum() <= 6, case
  np.testing.assert_allclose(float(np.asarray(hist['power']).sum()),
                             refPower.sum(), rtol=2e-3)
