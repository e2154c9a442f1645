"""Model assemblies: the vision and audio towers, BERT, MiCo, and the
stand-alone CLIP encoders (`clip_text`, `modified_resnet`, `timm_adapter`)."""
