"""Dense decoder LM: norms, RoPE, MLP, attention, assembly."""
