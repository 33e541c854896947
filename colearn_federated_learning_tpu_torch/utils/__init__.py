"""Configuration and deterministic random draws."""
