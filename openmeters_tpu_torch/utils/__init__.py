"""Host-side numerics the port needs: levels, windows, channels, weighting.

numpy copies of the reference helpers (``openmeters_tpu/utils``), carried
here because importing the reference package pulls in JAX.
"""
