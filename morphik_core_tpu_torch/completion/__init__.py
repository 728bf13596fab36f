"""Completion models of the port: the OpenAI-compatible, Ollama and
Anthropic providers over the stdlib transport, and the offline stub."""
