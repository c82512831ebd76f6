"""Host-side utilities of the port: the safetensors format, the config and
command line, video export."""
