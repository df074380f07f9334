"""Configuration and the registration model."""
