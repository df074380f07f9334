"""Configuration, the registration model and the VoxelMorph engine."""
