"""Click simulation: the PBM, UBM and cascade click models, the
propensity estimators, the ranking samplers and team-draft
multileaving."""
