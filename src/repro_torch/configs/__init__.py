"""One module per assigned architecture. Import registers the config."""
