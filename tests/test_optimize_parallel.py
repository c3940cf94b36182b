'''Parallel optimizeStrategyStep — the reference's concurrent
SweeperOptimizeWorker pool (parameter_sweeper.py:454-746) mapped onto OS
worker processes: per-worker history dumps, master global-best tracking,
sequential fallback for unpicklable configs.'''

import os
import sys

import numpy as np
import pytest

from optics_design_workbench.jupyter_utils import ParameterSweeper

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import optimize_helpers as OH


@pytest.mark.long
def test_parallel_strategies_find_optimum(tmp_path, monkeypatch):
  # worker subprocesses must import tests/optimize_helpers.py to unpickle
  # the factory/objective
  testsDir = os.path.dirname(os.path.abspath(__file__))
  monkeypatch.setenv('PYTHONPATH', os.pathsep.join(
      p for p in [testsDir, os.environ.get('PYTHONPATH', '')] if p))

  scene = OH.buildScene(str(tmp_path / 'opt'))
  sweeper = ParameterSweeper(OH.factory, scene=scene)
  results = sweeper.optimizeStrategyStep(
      [dict(minimizeFunc=OH.spotOffset, parameters=['x'],
            method='Nelder-Mead', maxIterations=6,
            simulationMode='singletrue', seed=5),
       dict(method='Powell', seed=6)],
      absWaitForParallel=120, pollSeconds=.5)
  assert len(results) == 2
  assert any(r is not None for r in results)
  # global best applied to the master's scene: source x near 3
  assert sweeper._bestParams is not None
  assert abs(sweeper._bestParams['x'] - 3.) < 0.5
  assert abs(float(scene.getObject('Src').placement[0, 3]) - 3.) < 0.5
  # worker histories merged into the master history
  assert len(sweeper.history) >= 6


def test_unpicklable_falls_back_sequential(tmp_path):
  scene = OH.buildScene(str(tmp_path / 'seq'))
  local = []   # closure makes the factory unpicklable

  def factory(sc):
    from optics_design_workbench.jupyter_utils import Parameter
    local.append(sc)
    return dict(x=Parameter(getter=lambda: OH._getX(sc),
                            setter=lambda v: OH._setX(sc, v),
                            bounds=(-10., 10.)))

  sweeper = ParameterSweeper(factory, scene=scene)
  results = sweeper.optimizeStrategyStep(
      [dict(minimizeFunc=lambda raw: OH.spotOffset(raw), parameters=['x'],
            method='Nelder-Mead', maxIterations=3,
            simulationMode='singletrue', seed=7),
       dict(maxIterations=2)])
  assert len(results) == 2
  assert sweeper._bestParams is not None
