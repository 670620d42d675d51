"""WGS84 -> UTM projection (host-side numpy; port of
``cooper_mapper_tpu/fusion/utm.py``, copied as it is).

Functional equivalent of ``utmProjection``
(L_SLAM/src/kf_fusion/utmProjection.cpp:9-118): the standard
Krueger series expansion for the transverse Mercator projection on the WGS84
ellipsoid.  Used by the GNSS adapter (fpd_receiver) to turn lat/lon fixes into
map-frame meters; no proj4 dependency.
"""

from __future__ import annotations

import numpy as np

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_K0 = 0.9996
_E2 = _F * (2.0 - _F)
_EP2 = _E2 / (1.0 - _E2)
_FALSE_EASTING = 500000.0
_FALSE_NORTHING_SOUTH = 10000000.0


def utm_zone(lon_deg):
    return int(np.floor((np.asarray(lon_deg) + 180.0) / 6.0)) % 60 + 1


def wgs84_to_utm(lat_deg, lon_deg, zone=None):
    """Returns (easting, northing, zone).  Accepts scalars or arrays."""
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    if zone is None:
        zone = utm_zone(np.mean(np.asarray(lon_deg)))
    lon0 = np.deg2rad(-183.0 + 6.0 * zone)

    sin_lat = np.sin(lat)
    cos_lat = np.cos(lat)
    tan_lat = np.tan(lat)

    N = _A / np.sqrt(1.0 - _E2 * sin_lat**2)
    T = tan_lat**2
    C = _EP2 * cos_lat**2
    Aa = (lon - lon0) * cos_lat

    # meridional arc
    M = _A * (
        (1 - _E2 / 4 - 3 * _E2**2 / 64 - 5 * _E2**3 / 256) * lat
        - (3 * _E2 / 8 + 3 * _E2**2 / 32 + 45 * _E2**3 / 1024) * np.sin(2 * lat)
        + (15 * _E2**2 / 256 + 45 * _E2**3 / 1024) * np.sin(4 * lat)
        - (35 * _E2**3 / 3072) * np.sin(6 * lat)
    )

    easting = _FALSE_EASTING + _K0 * N * (
        Aa
        + (1 - T + C) * Aa**3 / 6
        + (5 - 18 * T + T**2 + 72 * C - 58 * _EP2) * Aa**5 / 120
    )
    northing = _K0 * (
        M
        + N
        * tan_lat
        * (
            Aa**2 / 2
            + (5 - T + 9 * C + 4 * C**2) * Aa**4 / 24
            + (61 - 58 * T + T**2 + 600 * C - 330 * _EP2) * Aa**6 / 720
        )
    )
    northing = np.where(lat < 0, northing + _FALSE_NORTHING_SOUTH, northing)
    return easting, northing, zone


def gnss_to_map(lat_deg, lon_deg, alt, origin_lat, origin_lon, origin_alt):
    """GNSS fix -> local map-frame position (x east, y up, z north) relative
    to a configured map origin (fpdReceiver.cpp:94-101,140)."""
    zone = utm_zone(origin_lon)
    e, n, _ = wgs84_to_utm(lat_deg, lon_deg, zone)
    e0, n0, _ = wgs84_to_utm(origin_lat, origin_lon, zone)
    return np.stack(
        [np.asarray(e - e0), np.asarray(alt) - origin_alt, np.asarray(n - n0)], axis=-1
    )
