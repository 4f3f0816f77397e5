"""CLIP guidance: the view extractor and the sampling hook."""
