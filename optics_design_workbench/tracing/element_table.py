'''
Host-side builder for the optical-element device table consumed by the
tracer. Mirrors the per-OpticalGroup property set of the reference
(reference: freecad_elements/optical_group.py:29-96): OpticalType,
RefractiveIndex, Reflectivity, AbsorptionLength, Grating* parameters and
RecordHits — plus an optional dispersion table n(lambda) per element (the
reference only supports a constant RefractiveIndex; dispersive media there
require gratings).
'''

import numpy as np
import jax
import jax.numpy as jnp

from .tracer import OPTICAL_TYPES, GRATING_REFLECTION, GRATING_TRANSMISSION

_GRATING_TYPES = {'Reflection': GRATING_REFLECTION,
                  'Transmission': GRATING_TRANSMISSION}

# column offsets in table['packed']
(EP_OPTTYPE, EP_REFRINDEX, EP_REFLECTIVITY, EP_ABSLENGTH, EP_GRATTYPE,
 EP_GRATLPM, EP_GRATDIRX, EP_GRATDIRY, EP_GRATDIRZ, EP_GRATORDER,
 EP_RECORDHITS) = range(11)


def element(opticalType='Vacuum', refractiveIndex=1.0, reflectivity=1.0,
            absorptionLength=np.inf, gratingType='Reflection',
            gratingLinesPerMillimeter=1000., gratingLinesOrientation=(0, 0, 1),
            gratingDiffractionOrder=1, recordHits=False, dispersion=None,
            label=None):
  '''One optical element (an "OpticalGroup"). `dispersion` is an optional
  (lambdaGridNm, nValues) pair overriding refractiveIndex per wavelength.'''
  if opticalType not in OPTICAL_TYPES:
    raise ValueError(f'invalid optical type: {opticalType!r}')
  if gratingType not in _GRATING_TYPES:
    raise ValueError(f'invalid grating type: {gratingType!r}')
  return dict(opticalType=opticalType, refractiveIndex=float(refractiveIndex),
              reflectivity=float(reflectivity),
              absorptionLength=float(absorptionLength),
              gratingType=gratingType,
              gratingLinesPerMillimeter=float(gratingLinesPerMillimeter),
              gratingLinesOrientation=tuple(gratingLinesOrientation),
              gratingDiffractionOrder=float(gratingDiffractionOrder),
              recordHits=bool(recordHits), dispersion=dispersion,
              label=label)


def buildElementTable(elems, dtype=jnp.float32, devicePut=True):
  '''Pack element dicts into the SoA device table (host-side numpy with
  devicePut=False — the batched sweep stacks variant tables host-side).'''
  if not elems:
    raise ValueError('scene contains no optical elements')
  # assemble in numpy, transfer once: jnp.asarray(x, dtype=...) lowers the
  # dtype conversion as an on-device op — one tiny XLA compile each, ~0.5 s
  # per op over a remote-compile link
  npDtype = np.dtype(dtype.dtype if hasattr(dtype, 'dtype') else dtype)
  host = dict(
      optType=np.asarray([OPTICAL_TYPES[e['opticalType']] for e in elems],
                         dtype=np.int32),
      refrIndex=np.asarray([e['refractiveIndex'] for e in elems],
                           dtype=npDtype),
      reflectivity=np.asarray([e['reflectivity'] for e in elems],
                              dtype=npDtype),
      absorptionLength=np.asarray([e['absorptionLength'] for e in elems],
                                  dtype=npDtype),
      gratingType=np.asarray([_GRATING_TYPES[e['gratingType']]
                              for e in elems], dtype=np.int32),
      gratingLpm=np.asarray([e['gratingLinesPerMillimeter'] for e in elems],
                            dtype=npDtype),
      gratingDir=np.asarray([e['gratingLinesOrientation'] for e in elems],
                            dtype=npDtype),
      gratingOrder=np.asarray([e['gratingDiffractionOrder'] for e in elems],
                              dtype=npDtype),
      recordHits=np.asarray([e['recordHits'] for e in elems], dtype=bool),
  )
  table = dict(host)
  # packed per-element row for the batched tracer (one gather per bounce):
  # [optType, refrIndex, reflectivity, absorptionLength, gratingType,
  #  gratingLpm, gratingDir(3), gratingOrder, recordHits]
  packed = np.stack([np.array([
      float(OPTICAL_TYPES[e['opticalType']]),
      e['refractiveIndex'], e['reflectivity'], e['absorptionLength'],
      float(_GRATING_TYPES[e['gratingType']]),
      e['gratingLinesPerMillimeter'],
      *e['gratingLinesOrientation'],
      e['gratingDiffractionOrder'],
      float(bool(e['recordHits']))]) for e in elems])
  table['packed'] = packed.astype(npDtype)
  if any(e.get('dispersion') is not None for e in elems):
    grids = [np.asarray(e['dispersion'][0], dtype=float)
             for e in elems if e.get('dispersion') is not None]
    lamGrid = grids[0]
    for g in grids[1:]:
      if len(g) != len(lamGrid) or not np.allclose(g, lamGrid):
        raise ValueError('all dispersion tables must share one wavelength '
                         'grid')
    rows, hasDisp = [], []
    for e in elems:
      if e.get('dispersion') is not None:
        rows.append(np.asarray(e['dispersion'][1], dtype=float))
        hasDisp.append(True)
      else:
        rows.append(np.full(len(lamGrid), e['refractiveIndex']))
        hasDisp.append(False)
    table['nLambda'] = lamGrid.astype(npDtype)
    table['nTable'] = np.stack(rows).astype(npDtype)
    table['hasDispersion'] = np.asarray(hasDisp, dtype=bool)
  # ONE batched host->device transfer
  out = jax.device_put(table) if devicePut else dict(table)
  # host copy so consumers (tracing/diff.py grating co-rotation) never pay
  # a device->host fetch to inspect optical types
  out['_hostOptType'] = host['optType']
  return out
