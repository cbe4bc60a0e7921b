// mp3rgain_tpu native host core — C ABI.
//
// Host-side byte-level engine of the framework: MP3 frame sync and
// global_gain bit surgery, APEv2 tag engine, MP4 box engine, and the MP3
// decode front-end (side info / scalefactors / Huffman / bit reservoir)
// that produces dense granule tensors for the JAX/Pallas decode back-end.
//
// All functions operate on caller-owned buffers; no file I/O and no global
// state. Behavioral contract follows the reference implementation
// (see /root/reference/src/lib.rs and src/mp4meta.rs citations per function).

#ifndef MP3RGAIN_NATIVE_H
#define MP3RGAIN_NATIVE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// ---------------------------------------------------------------------------
// L0 bitstream core (reference: src/lib.rs)
// ---------------------------------------------------------------------------

// Result of a whole-file gain analysis (reference: src/lib.rs:57-75).
typedef struct {
  int64_t frame_count;
  uint8_t min_gain;
  uint8_t max_gain;
  double avg_gain;
  int32_t mpeg_version;  // 1, 2, or 25 (for 2.5)
  int32_t channel_mode;  // 0 stereo, 1 joint, 2 dual, 3 mono
} MgAnalysis;

// Analyze global_gain statistics over all audio frames.
// Returns 0 on success, -1 if no valid MP3 frames found.
int32_t mg_analyze(const uint8_t* data, size_t len, MgAnalysis* out);

// Apply `steps` to every global_gain field, in place.
// mode: 0 = saturating (clamp 0..255), 1 = wrapping (mod 256).
// Returns number of modified frames (>= 0).
int64_t mg_apply_gain(uint8_t* data, size_t len, int32_t steps, int32_t mode);

// Apply `steps` to a single channel (0 = left, 1 = right), saturating.
// Returns number of modified frames. Caller must pre-check mono files.
int64_t mg_apply_gain_channel(uint8_t* data, size_t len, int32_t channel,
                              int32_t steps);

// Export every global_gain value, in frame/granule/channel order.
// Returns count written, or -(needed) if cap is too small.
int64_t mg_read_gains(const uint8_t* data, size_t len, uint8_t* gains,
                      int64_t cap);

// Export the frame index: for each audio frame writes
// {offset, frame_size, header_word} triples into `out` (cap = triple count).
// Returns number of frames, or -(needed) if cap is too small.
int64_t mg_frame_index(const uint8_t* data, size_t len, int64_t* out,
                       int64_t cap);

// End of audio data (before APE/ID3v1 trailers); reference src/lib.rs:358-383.
int64_t mg_find_audio_end(const uint8_t* data, size_t len);

// Unaligned 8-bit field read/write (test hooks; reference src/lib.rs:301-340).
uint8_t mg_read_bits8(const uint8_t* data, size_t len, size_t byte_offset,
                      uint8_t bit_offset);
void mg_write_bits8(uint8_t* data, size_t len, size_t byte_offset,
                    uint8_t bit_offset, uint8_t value);

// ---------------------------------------------------------------------------
// APEv2 tag engine (reference: src/lib.rs:838-1163)
// ---------------------------------------------------------------------------

// Find APEv2 footer start (at EOF, or before a trailing ID3v1 tag).
// Returns offset or -1 (reference src/lib.rs:944-966).
int64_t mg_ape_find_footer(const uint8_t* data, size_t len);

// Parse an APEv2 tag into a packed item list:
//   for each item: u32le key_len, u32le value_len, key bytes, value bytes.
// Returns number of bytes written to `out`, -1 if no/invalid tag,
// or -(needed) if cap too small. `*item_count` receives the item count.
int64_t mg_ape_parse(const uint8_t* data, size_t len, uint8_t* out,
                     int64_t cap, int64_t* item_count);

// Serialize a packed item list (format as above) into a full APEv2 tag
// (header + items + footer). Empty list serializes to 0 bytes.
// Returns bytes written or -(needed).
int64_t mg_ape_serialize(const uint8_t* items, size_t items_len,
                         int64_t item_count, uint8_t* out, int64_t cap);

// Compute the layout for removing an APE tag (reference src/lib.rs:1088-1119):
// *audio_end = end of audio bytes, *tail_start = start of trailing bytes to
// keep (ID3v1 after the APE tag) or -1 if none. Returns 0 if a tag was found,
// -1 if not (in which case the file is unchanged).
int32_t mg_ape_remove_region(const uint8_t* data, size_t len,
                             int64_t* audio_end, int64_t* tail_start);

#ifdef __cplusplus
}  // extern "C"
#endif

#endif  // MP3RGAIN_NATIVE_H
