"""The Arrow pair-HMM model: parameters, moments, fills, refinement."""
