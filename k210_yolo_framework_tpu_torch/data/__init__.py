"""Host input pipeline (JPEG decode, staging) and the on-device preprocess."""
