"""CLIP (ViT and text towers), its tokenizer and the weight converter."""
