"""Numerical constants of the Hosek-Wilkie sun/sky model and its TGMM sampler.

These mirror the published model configuration used by the reference
implementation (see reference `include/mitsuba/render/sunsky/sunsky.h:19-65`),
the same values as `tpusky/models/sunsky/constants.py`:

* Hosek & Wilkie 2012, "An Analytic Model for Full Spectral Sky-Dome Radiance"
* Hosek & Wilkie 2013, "Adding a Solar-Radiance Function to the Hosek-Wilkie
  Skylight Model"
* Vitsas, Vardis & Papaioannou 2021, "Sampling Clear Sky Models using
  Truncated Gaussian Mixtures"
"""

import numpy as np

# --- Spectral discretisation of the datasets -------------------------------
N_WAVELENGTHS = 11
WAVELENGTH_STEP = 40.0
WAVELENGTHS = np.arange(320.0, 721.0, WAVELENGTH_STEP)  # 320..720 nm

# --- Dataset grid sizes ----------------------------------------------------
N_TURBIDITY = 10            # turbidity levels 1..10
N_ALBEDO = 2                # albedo grid {0, 1}
N_SKY_CTRL_PTS = 6          # quintic Bezier control points over elevation
N_SKY_PARAMS = 9            # parameters of the sky radiance formula

N_SUN_CTRL_PTS = 4          # order-4 polynomial per elevation segment
N_SUN_SEGMENTS = 45         # piecewise segments over elevation
N_SUN_LD_PARAMS = 6         # limb-darkening polynomial order

# --- TGMM sampling tables (Vitsas et al. 2021) -----------------------------
N_TGMM_TURBIDITY = 9        # tabulated at turbidity 2..10
N_ETAS = 30                 # sun elevations 2..89 deg, step 3
N_GAUSSIANS = 5             # gaussians per mixture
N_GAUSSIAN_PARAMS = 5       # (mu_phi, mu_theta, sigma_phi, sigma_theta, weight)
N_MIX_GAUSSIANS = 4 * N_GAUSSIANS  # bilinear blend of 4 neighbouring mixtures

# --- Sun geometry ----------------------------------------------------------
SUN_APERTURE_DEG = 0.5358                      # full aperture in degrees
SUN_HALF_APERTURE = np.deg2rad(0.5358 / 2.0)   # radians
EARTH_MEAN_RADIUS = 6371.01                    # km
ASTRONOMICAL_UNIT = 149597890.0                # km

# --- Radiometric conversion constants --------------------------------------
# Scale applied to the (limb-darkening-integrated) RGB solar dataset so its
# magnitude matches the spectral pipeline (reference `sunsky.h:62`).
SPEC_TO_RGB_SUN_CONV = 467.069280386
# Normalisation of the CIE-Y integral so a unit spectrum has luminance 1
# (reference `include/mitsuba/core/spectrum.h:132`).
CIE_Y_NORMALIZATION = 1.0 / 106.7502593994140625

# Wavelength range covered by the CIE tables used for spectral->XYZ.
CIE_MIN = 360.0
CIE_MAX = 830.0

# --- Sampling guards -------------------------------------------------------
# f32 machine-epsilon-scale guard used to (a) clamp inverse-CDF arguments to
# erfinv's open domain and (b) bound 1/sin(theta) at the zenith in the TGMM
# pdf (reference `sunsky.cpp:985`).
EPSILON_F32 = float(np.finfo(np.float32).eps / 2)  # 2^-24, dr::Epsilon<f32>
SIN_OFFSET = EPSILON_F32

# Flattened dataset sizes (used by the .bin parser sanity checks)
SKY_PARAM_SHAPE_RGB = (N_TURBIDITY, N_ALBEDO, N_SKY_CTRL_PTS, 3, N_SKY_PARAMS)
SKY_PARAM_SHAPE_SPEC = (N_TURBIDITY, N_ALBEDO, N_SKY_CTRL_PTS, N_WAVELENGTHS,
                        N_SKY_PARAMS)
SKY_RAD_SHAPE_RGB = (N_TURBIDITY, N_ALBEDO, N_SKY_CTRL_PTS, 3)
SKY_RAD_SHAPE_SPEC = (N_TURBIDITY, N_ALBEDO, N_SKY_CTRL_PTS, N_WAVELENGTHS)
SUN_RAD_SHAPE_RGB = (N_TURBIDITY, N_SUN_SEGMENTS, 3, N_SUN_CTRL_PTS,
                     N_SUN_LD_PARAMS)
SUN_RAD_SHAPE_SPEC = (N_TURBIDITY, N_SUN_SEGMENTS, N_WAVELENGTHS,
                      N_SUN_CTRL_PTS)
SUN_LD_SHAPE = (N_WAVELENGTHS, N_SUN_LD_PARAMS)
TGMM_SHAPE = (N_TGMM_TURBIDITY, N_ETAS, N_GAUSSIANS, N_GAUSSIAN_PARAMS)
