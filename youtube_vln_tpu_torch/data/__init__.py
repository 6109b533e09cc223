"""Host data pipeline of the port: feature store, readers, tokenizer,
samplers, instruction generators, pretraining datasets and the loader
(numpy only; copies of the JAX package's modules)."""
