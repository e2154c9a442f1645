"""Model assemblies: EVA ViT, BERT interface, MiCo."""
