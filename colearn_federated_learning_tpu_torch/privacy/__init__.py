"""Privacy on the device: DP clip and noise, secure-aggregation masks, and
the RDP (ε, δ) accountant."""
