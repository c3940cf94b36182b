'''
Example 3 — lens-radius parameter sweep / optimization minimizing detector
spot size (reference: examples/3-parameter-sweeps/main.FCStd + sweep.ipynb).

Shows both workflows:
  * scipy optimization through ParameterSweeper.optimize (the reference's
    path: one simulation per evaluation),
  * the batched sweep: every candidate radius compiled into one stacked
    scene and traced by ONE jitted step (a lax.map over the variants).
'''

import numpy as np

from optics_design_workbench.models import (Scene, PointSource,
                                            OpticalGroup)
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench.jupyter_utils import (ParameterSweeper,
                                                   Parameter)


def buildScene(lensRadius=60., path='example3'):
  scene = Scene(label='example3', path=path)
  R, aperture, thickness = float(lensRadius), 20., 5.
  sag = R - np.sqrt(R ** 2 - aperture ** 2)
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Lens', Label='Lens', RefractiveIndex=1.5,
      surfaces=[
          S.sphere(T.translation(0, 0, R), elem=0, radius=R,
                   zRange=(-R, -R + sag + 1e-6), orient=+1),
          S.plane(T.translation(0, 0, thickness), elem=0, radius=aperture,
                  orient=+1),
          S.cylinder(T.translation(0, 0, thickness / 2), elem=0,
                     radius=aperture,
                     zRange=(-thickness / 2, thickness / 2), orient=+1)],
      placements=[T.translation(0, 0, 40)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(60., 60.))],
      placements=[T.translation(0, 0, 160)]))
  # collimated gaussian beam: with parallel input the ideal focus sits at
  # f = R/(n-1), i.e. R = 60 mm puts the focus on the detector at z = 160
  scene.addSource(PointSource(Label='Source',
                              PowerDensity='exp(-r^2/50)',
                              FocalLength='inf',
                              RadiusDomain='0, 15',
                              RadiusResolutionNumericMode='1e4'))
  scene.addSimulationSettings(EndAfterRays='2e4', RaysPerIteration=20000,
                              MaxIntersections=6,
                              EnableStoreSingleShotData=True)
  return scene


def main():
  holder = dict(scene=buildScene(), R=60.)

  def setRadius(r):
    holder['R'] = float(r)
    holder['scene'] = buildScene(float(r))
    sweeper.scene = holder['scene']   # keep the optimizer on the new scene

  sweeper = ParameterSweeper(
      lambda sc: dict(R=Parameter(getter=lambda: holder['R'],
                                  setter=setRadius, bounds=(40., 100.))),
      scene=holder['scene'])

  # --- batched sweep: all radii in ONE jitted step ---
  radii = np.linspace(45., 95., 11)

  def spotMetric(power, counts):
    H = counts[0]
    n = H.sum()
    if n == 0:
      return 1e9
    ys, xs = np.indices(H.shape)
    cy, cx = (H * ys).sum() / n, (H * xs).sum() / n
    return float((H * ((ys - cy) ** 2 + (xs - cx) ** 2)).sum() / n)

  metrics = sweeper.evaluateBatched(
      [dict(R=r) for r in radii], spotMetric,
      sceneFactory=lambda: holder['scene'],
      raysPerScene=20000, maxIntersections=6, bins=(64, 64),
      histBounds=(-40., 40., -40., 40.))
  for r, m in zip(radii, metrics):
    print(f'R={r:6.1f} mm -> spot second moment {m:8.2f} bins^2')
  best = radii[int(np.argmin(metrics))]
  print(f'batched sweep best radius: {best:.1f} mm '
        f'(paraxial theory: f=120 mm -> R = f*(n-1) = 60 mm)')

  # --- reference-style scipy optimization (one simulation per step) ---
  def spotSize(raw):
    hits = raw.loadHits('Detector')
    p = hits.points()
    if len(p) < 100:
      return 1e6
    return float(np.hypot(p[:, 0] - p[:, 0].mean(),
                          p[:, 1] - p[:, 1].mean()).std())

  sweeper.scene = holder['scene']
  result = sweeper.optimize(spotSize, ['R'], method='Nelder-Mead',
                            maxIterations=10, seed=1)
  print(f'scipy optimize best: R={result.bestParams["R"]:.1f} mm, '
        f'spot std {result.bestPenalty:.2f} mm '
        f'({len(sweeper.history)} evaluations)')


if __name__ == '__main__':
  main()
