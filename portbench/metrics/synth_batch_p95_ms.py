"""95th percentile, over every batch of the window, of a batch's time
from its inputs handed over to its waveforms on the host (host clock)."""
import numpy as np


def read(record):
    if record.get('kind') != 'synth':
        return None
    lat = [it['t2'] - it['t0'] for it in record['items']]
    return float(np.percentile(lat, 95)) * 1e3
