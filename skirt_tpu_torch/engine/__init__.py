"""The photon-packet lifecycle engine (twin of skirt_tpu.engine; slice 1:
the fused polychromatic analytic path)."""
