"""The port's network, schedule, masking and DDPM sampler."""
