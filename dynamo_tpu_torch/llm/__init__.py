"""The LLM pipeline stages in front of the engine: the tokenizer, the
OpenAI preprocessor, the detokenizing backend and model path resolution."""
