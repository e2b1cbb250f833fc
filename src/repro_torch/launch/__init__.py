"""Command-line front ends of the port (``python -m repro_torch.launch.<name>``)."""
