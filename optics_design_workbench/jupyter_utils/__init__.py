'''
Notebook-facing API (reference: jupyter_utils/__init__.py:11-16): Document
(a.k.a. FreecadDocument), ParameterSweeper, rawFolders/latestRawFolder,
Hits, Histogram, setupProgressTracker.
'''

from .document import (Document, FreecadDocument, RawFolder, RawFolderRange,
                       rawFolders, rawFolderByIndex, latestRawFolder,
                       updateResultEntry, saveScene, loadScene)
from .hits import Hits
from .histogram import Histogram
from .parameter_sweeper import ParameterSweeper, Parameter, MetaParameter
from .progress import ProgressTracker, setupProgressTracker
from .retries import retryOnError
from .transforms import applyTransformation
from ..simulation.draw import DrawnRays
from ..geometry.tessellate import plotScene, writeScenePLY
from ..tracing.diff import applyParams, makeSpotLoss, optimizeGradient


def openFreecadGui(*args, **kwargs):
  '''The reference launches an interactive FreeCAD GUI
  (freecad_document.py:1253-1297); this framework has no GUI process.
  Visualize results with Hits.plot()/Histogram.plot() or export ray
  polylines via RawFolder.loadRays().'''
  raise NotImplementedError(
      'no GUI in optics_design_workbench; use Hits.plot() / '
      'Histogram.plot() or RawFolder.loadRays() for visualization')
