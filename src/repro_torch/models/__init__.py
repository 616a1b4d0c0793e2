"""Dense decoder and the model facade."""
