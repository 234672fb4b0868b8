from cavp_tpu_torch.audio.mel import mel_spectrogram, preprocess_audio

__all__ = ["mel_spectrogram", "preprocess_audio"]
