"""Config dataclasses, device selection and latency windows."""
