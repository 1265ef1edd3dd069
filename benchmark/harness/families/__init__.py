"""Model families, one module each, found by a configuration file's
`model_type` (`registry.family`): `<model_type>.py` here."""
