"""Test oracles and fixture generation (not part of the framework runtime).

- fixtures: encode synthetic PCM to MP3 via the system libmp3lame (ctypes).
- mpg123: golden-reference MP3 decode via the system libmpg123 (ctypes), used
  to validate the framework's own host+device decoder, mirroring the reference's
  differential-testing strategy (scripts/compatibility-test.sh).
"""
