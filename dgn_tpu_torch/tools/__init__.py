"""Command-line tools over the port's runs and datasets."""
