"""Physical and code constants.

Replaces the reference's ``constants_module.F90`` and
``misc_definitions_module.F90`` (projection codes
``misc_definitions_module.F90:38-47``, stagger codes ``:29``,
NAN sentinel ``:12``).
"""

import math

PI = math.pi
DEG_PER_RAD = 180.0 / PI
RAD_PER_DEG = PI / 180.0

#: Mean Earth radius in m, consistent with NCEP/MM5 (constants_module.F90:25).
EARTH_RADIUS_M = 6370000.0
EARTH_CIRC_M = 2.0 * PI * EARTH_RADIUS_M

A_WGS84 = 6378137.0
B_WGS84 = 6356752.314
E_WGS84 = 0.081819192
A_NAD83 = 6378137.0
E_NAD83 = 0.0818187034

P0 = 1.0e5
RD = 287.0
CP = 1004.0

#: "unset" sentinel used by the namelist reader (misc_definitions_module.F90:12).
NAN = 1.0e20

# Projection codes (misc_definitions_module.F90:38-47) — preserved verbatim
# because the MAP_PROJ global attribute of the output file is this integer
# (write_data.F90:257).
PROJ_LATLON = 0
PROJ_LC = 1
PROJ_PS = 2
PROJ_MERC = 3
PROJ_GAUSS = 4
PROJ_CYL = 5
PROJ_CASSINI = 6
PROJ_PS_WGS84 = 102
PROJ_ALBERS_NAD83 = 105
PROJ_ROTLL = 203

# Stagger codes (misc_definitions_module.F90:29).
M = 1
U = 2
V = 3
HH = 4
VV = 5
CORNER = 6

#: Special value declared (but never applied — quirk Q5) by the reference
#: (interp.F90:87).
SPVAL = 9.9e10
