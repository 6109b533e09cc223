"""Host data pipeline of the port: feature store, readers, tokenizer,
samplers, instruction generators, navigation graphs, the pretraining and
R2R beam datasets and the loader (numpy only; copies of the JAX package's
modules)."""
