"""The 95th percentile (linear between order statistics) of the latency of
every call in the window, from the call to its returned array, in ms."""

import numpy as np


def read(rec):
    lat = [j["latency_s"] * 1e3 for j in rec.jobs]
    return float(np.percentile(lat, 95)) if lat else None
