"""Click simulation: the PBM click model (UBM and cascade are not ported
yet)."""
