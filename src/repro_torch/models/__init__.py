# Dense-LM model code: configs, parameters, layers, the decoder, conversion.
