"""The UrbanSound8K classifier: conv front end, encoder, CNN head."""
