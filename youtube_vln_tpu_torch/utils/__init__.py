"""Command line, model configuration and run management of the entries."""
