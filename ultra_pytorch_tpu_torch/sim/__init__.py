"""Click simulation: the PBM click model, the propensity estimators and
the ranking samplers (UBM and cascade are not ported yet)."""
