"""The native host-side data runtime (``native.py`` over
``csrc/motiondata.cpp``): npy loading, window slicing, statistics, shuffles
and normalisation in C++, built with g++ at first use."""

from .native import (
    available,
    ensure_built,
    load_library,
    load_npy_f32,
    load_npy_f32_numpy,
    mean_std,
    mean_std_numpy,
    normalize_inplace,
    normalize_inplace_numpy,
    shuffle_indices,
    shuffle_indices_numpy,
    slice_windows,
    slice_windows_numpy,
)
