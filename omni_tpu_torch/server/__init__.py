"""The OpenAI-style HTTP server of the port (counterpart of
omni_tpu/server/)."""
