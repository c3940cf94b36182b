'''Picklable factory + objective for the parallel optimizeStrategyStep test
(worker processes reconstruct the sweeper from these module-level
functions, the analog of the reference's SweeperOptimizeWorker document
reload).'''

import numpy as np

from optics_design_workbench.models import (Scene, PointSource,
                                            OpticalGroup)
from optics_design_workbench.geometry import surfaces as S
from optics_design_workbench.geometry import transforms as T
from optics_design_workbench.jupyter_utils import Parameter


def buildScene(path):
  scene = Scene(label='opt', path=path)
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(80., 80.))],
      placements=[T.translation(0, 0, 100)]))
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.01)',
      ThetaDomain='0, pi/4', ThetaResolutionNumericMode='2e3'))
  scene.addSimulationSettings(RaysPerIteration=3000, MaxIntersections=3,
                              EnableStoreSingleShotData=True)
  return scene


def _getX(scene):
  return float(scene.getObject('Src').placement[0, 3])


def _setX(scene, v):
  scene.getObject('Src').placement[0, 3] = float(v)


def factory(scene):
  return dict(x=Parameter(getter=lambda: _getX(scene),
                          setter=lambda v: _setX(scene, v),
                          bounds=(-10., 10.)))


def spotOffset(raw):
  '''Objective: |mean detector-hit x - 3| — optimum at source x = 3.'''
  hits = raw.loadHits('Det')
  p = hits.points()
  if len(p) < 100:
    return 1e6
  return abs(float(p[:, 0].mean()) - 3.)
