"""Coloured console prefixes for the command-line entry points.

Counterpart of ``k210_yolo_framework_tpu/utils/console.py`` (a copy: the port
loads nothing of the JAX package)."""

INFO = "\033[94m[ INFO  ]\033[0m"
ERROR = "\033[91m[ ERROR ]\033[0m"
NOTE = "\033[92m[ NOTE ]\033[0m"
