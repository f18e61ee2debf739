# LLM serving (prefill + single-token decode) for the dense family; see llm_decode.
