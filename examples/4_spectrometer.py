'''
Example 4 — grating spectrometer (reference: docs/example-spectrometer.rst,
the 4th benchmark config in BASELINE.md): two wavelengths hit a reflection
grating at normal incidence and are angularly resolved onto a detector.

First-order diffraction (Ludwig 1970, ray.py:445-487 parity) puts each
wavelength at sin(theta) = m * lambda / d; with 500 lines/mm (d = 2 um):
450 nm -> 23.2 mm and 650 nm -> 34.4 mm from the axis at 100 mm distance.
'''

import numpy as np

from optics_design_workbench.models import (Scene, PointSource,
                                            OpticalGroup)
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench import simulation
from optics_design_workbench.jupyter_utils import RawFolder

LINES_PER_MM = 500.
GRATING_Z = 100.


def buildScene(path='example4', wavelengths=(450., 650.)):
  scene = Scene(label='example4', path=path)
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Grating', Label='Grating',
      GratingType='Reflection',
      GratingLinesPerMillimeter=LINES_PER_MM,
      GratingDiffractionOrder=1,
      GratingLinesOrientation=(1., 0., 0.),
      surfaces=[S.plane(np.eye(4), elem=0, radius=40., orient=-1)],
      placements=[T.translation(0, 0, GRATING_Z)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(80., 80.))],
      placements=[T.translation(0, 0, 0)]))
  for wl in wavelengths:
    scene.addSource(PointSource(
        Label=f'Source{int(wl)}', PowerDensity='exp(-theta^2/1e-6)',
        Wavelength=wl, ThetaDomain='0, 0.01',
        ThetaResolutionNumericMode='2e3'))
  scene.addSimulationSettings(RaysPerIteration=20000, MaxIntersections=3,
                              EnableStoreSingleShotData=True)
  return scene


def expectedPosition(wavelengthNm, order=1):
  d = 1000. / LINES_PER_MM                  # um per line
  sinT = order * (wavelengthNm / 1000.) / d
  return GRATING_Z * np.tan(np.arcsin(sinT))


def main():
  scene = buildScene()
  runPath = simulation.runSimulation(scene, 'singletrue', seed=4)
  raw = RawFolder(runPath)
  print(f'run: {runPath}')
  for wl in (450, 650):
    hits = raw.loadHits('Detector', source=f'Source{wl}')
    pts = hits.points()
    pos = np.hypot(pts[:, 0], pts[:, 1]).mean()
    print(f'{wl} nm: {len(hits)} hits, spectral line at {pos:.2f} mm '
          f'(grating equation: {expectedPosition(wl):.2f} mm)')


if __name__ == '__main__':
  main()
