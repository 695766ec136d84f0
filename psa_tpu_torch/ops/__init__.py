"""Device compute: the SED projection kernel and the spectral ops."""
