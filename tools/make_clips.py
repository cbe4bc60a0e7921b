"""Regenerate the committed corpus clips (mp3rgain_tpu/testing/clips/).

Needs libmp3lame and libavcodec. The clips are a few seconds per format,
MP3 with the bit reservoir off and AAC-LC as ADTS, from which
mp3rgain_tpu.testing.corpus builds long tracks by concatenating whole
frames (see chip_smoke.py).

Run: python tools/make_clips.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mp3rgain_tpu.testing import corpus  # noqa: E402

if __name__ == "__main__":
    for path in corpus.make_clips():
        print(f"{os.path.getsize(path):8d}  {path}")
