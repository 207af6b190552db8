"""The LM side of the port: qwen3-style dense GQA decoders (prefill with
the flash kernel, KV-cache decode)."""
