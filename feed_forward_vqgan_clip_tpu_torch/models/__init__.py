"""Model modules: the CLIP towers, the mappers, the VQGAN decoder, the flow prior,
and the VGG16 and InceptionV3 feature extractors of the diversity loss and FID."""
